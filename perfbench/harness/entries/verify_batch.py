"""A batch of proofs verified as one call:
`parallel.batch_verify.batch_verify(snarks, srs, scheme, transcript)`, the
succinct phase and the pairing decide, one accept bit a proof brought to
the host.  The check holds every lane's bit of every call in the window to
the reference's verdict on that lane's proof."""

from __future__ import annotations

import importlib
import json
import time

import numpy as np

from . import EntryBase
from ._proofs import ProofPool

PROGRAM = "snark_verifier_tpu_torch.parallel.batch_verify"


def msm_terms(pool: ProofPool) -> int:
    """The terms of one proof's verify MSM: every preprocessed commitment,
    every point of the proof, and the generator of the constant term."""
    with open(pool.protocol_path) as f:
        n_pre = len(json.load(f)["preprocessed"])
    return n_pre + len(pool.rows[0][2]) + 1


class Entry(EntryBase):
    spans = ("snark_verifier_tpu_torch.sdk.aggregation:_stack_streams",
             "snark_verifier_tpu_torch.sdk.aggregation:_instance_block",
             "snark_verifier_tpu_torch.sdk.aggregation:succinct_plan",
             "snark_verifier_tpu_torch.parallel.batch_verify:batch_succinct_verify",
             "snark_verifier_tpu_torch.parallel.batch_verify:decide_all")
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
        self.batches = self.pool.program_batches(Snark, protocol)
        self.scheme, self.transcript = run.config["scheme"], run.traffic["transcript"]

    @property
    def n_inputs(self) -> int:
        return len(self.batches)

    def call(self, k, timings=None):
        oks = self.program.batch_verify(self.batches[k], self.srs, self.scheme, self.transcript,
                                        device=self.device, timings=timings)
        return oks.cpu().numpy()

    def work(self, k) -> float:
        return float(len(self.pool.plan.batches[k]))

    def free(self):
        self.batches = self.srs = None
        super().free()

    def expected(self, decide: bool = True):
        """The reference's accept bits of every input; `decide=False` gives
        the control's (a verifier that skips the decider)."""
        verdicts = self.pool.reference_map("verdict", decide)
        return [np.array([verdicts[ProofPool.key(lane)] for lane in batch])
                for batch in self.pool.plan.batches]

    def control_answers(self):
        return self.expected(decide=False)

    def check(self, run):
        want = self.expected()
        wrong = [int((np.asarray(r.out, dtype=bool) != want[r.k]).sum()) for r in run.records]
        self.failed_calls = sum(1 for w in wrong if w)
        run.counts["msm_terms"] = msm_terms(self.pool)
        return [("lanes_wrong", sum(wrong), 0)]
