"""A recursion tree folded to its root as one call:
`sdk.tree_aggregation.tree_aggregate_root(snarks, srs)`, the leaves'
succinct verification, layer 1's grouped folds, layer 2's root fold and
one pairing decide; the root (lhs, rhs) and its accept bit brought to the
host.  The check holds every call's root and bit to the reference's tree
over the same leaves."""

from __future__ import annotations

import importlib
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import reference
from reference import poseidon
from reference.accumulation import fold, group_size
from reference.protocol import PlonkProtocol as RefProtocol

from .. import codec
from . import EntryBase
from ._proofs import ProofPool

PROGRAM = "snark_verifier_tpu_torch.sdk.tree_aggregation"


def fold_perms(n: int) -> int:
    """Poseidon permutations of a fold of n accumulators: 4n elements at
    rate 2, then the padding permutation."""
    return 2 * n + 1


class Entry(EntryBase):
    spans = ("snark_verifier_tpu_torch.sdk.tree_aggregation:batch_succinct_verify",
             "snark_verifier_tpu_torch.sdk.tree_aggregation:_layer2",
             "snark_verifier_tpu_torch.sdk.tree_aggregation:decide",
             "snark_verifier_tpu_torch.sdk.aggregation:_stack_streams",
             "snark_verifier_tpu_torch.sdk.aggregation:succinct_plan")
    has_timings = True

    def setup(self):
        from snark_verifier_tpu_torch.sdk.snark import Snark
        from snark_verifier_tpu_torch.sdk.srs import load_params
        from snark_verifier_tpu_torch.verifier.plonk.protocol import PlonkProtocol

        run = self.run
        self.program = importlib.import_module(PROGRAM)
        self.pool = ProofPool(run.config, run.traffic, run.seed)
        t = time.perf_counter()
        self.srs = load_params(str(self.pool.srs_path))
        run.spans["setup.srs_load_s"] = time.perf_counter() - t
        with open(self.pool.protocol_path) as f:
            protocol = PlonkProtocol.from_json(json.load(f))
        self.trees = self.pool.program_batches(Snark, protocol)

    @property
    def n_inputs(self) -> int:
        return len(self.trees)

    def call(self, k, timings=None):
        lhs, rhs, ok = self.program.tree_aggregate_root(self.trees[k], self.srs,
                                                        self.run.config["scheme"],
                                                        device=self.device, timings=timings)
        return lhs.cpu().numpy(), rhs.cpu().numpy(), bool(ok)

    def work(self, k) -> float:
        return float(len(self.pool.plan.batches[k]))

    def free(self):
        self.trees = self.srs = None
        super().free()

    def expected(self, decide: bool = True):
        """The reference's (lhs, rhs, accept bit) of every input's tree;
        `decide=False` gives the control's (a root that is never decided).
        Layer 1's group folds run on a few processes."""
        srs = self.pool.reference_srs()
        accs = self.pool.reference_map("accumulator")
        trees = [[accs[ProofPool.key(lane)] for lane in batch] for batch in self.pool.plan.batches]
        jobs = []
        for leaves in trees:
            g = group_size(len(leaves))
            jobs.append([leaves[i:i + g] for i in range(0, len(leaves), g)] if g else [leaves])
        flat = [grp for groups in jobs for grp in groups]
        workers = max(1, min(6, (os.cpu_count() or 2) - 1))
        if workers > 1 and len(flat) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
                folded = list(ex.map(fold, flat, chunksize=max(1, len(flat) // (4 * workers))))
        else:
            folded = [fold(grp) for grp in flat]
        out, i = [], 0
        for leaves, groups in zip(trees, jobs):
            layer1 = folded[i:i + len(groups)]
            i += len(groups)
            top = fold(layer1) if len(groups) > 1 else layer1[0]
            lhs, rhs = fold([top])
            out.append((lhs, rhs, srs.decide(lhs, rhs) if decide else True))
        return out

    def control_answers(self):
        return [(codec.encode(l, 32), codec.encode(r, 32), ok)
                for l, r, ok in self.expected(decide=False)]

    def count_perms(self, srs) -> int:
        """Poseidon permutations of one tree: each leaf's transcript (counted
        on one honest leaf's reference run) and every fold's."""
        key = next(k for k in self.pool.keys() if k[0] == "fixture")
        with open(self.pool.protocol_path) as f:
            leaf = reference.Snark(RefProtocol.from_json(json.load(f)), *self.pool.content(key))
        before = poseidon.PERMUTATIONS[0]
        reference.succinct_verify(leaf, srs.g, self.pool.scheme, self.pool.transcript)
        per_leaf = poseidon.PERMUTATIONS[0] - before
        n = len(self.pool.plan.batches[0])
        g = group_size(n)
        folds = (n // g) * fold_perms(g) + fold_perms(n // g) if g else fold_perms(n)
        return n * per_leaf + folds + fold_perms(1)

    def check(self, run):
        want = self.expected()
        roots_wrong = verdicts_wrong = 0
        for r in run.records:
            lhs, rhs, ok = r.out
            got = (codec.affine(lhs, 32), codec.affine(rhs, 32))
            bad_root = got != want[r.k][:2]
            bad_bit = ok != want[r.k][2]
            roots_wrong += bad_root
            verdicts_wrong += bad_bit
            self.failed_calls += bool(bad_root or bad_bit)
        run.counts["poseidon_perms_per_tree"] = self.count_perms(self.pool.reference_srs())
        return [("roots_wrong", roots_wrong, 0), ("verdicts_wrong", verdicts_wrong, 0)]
