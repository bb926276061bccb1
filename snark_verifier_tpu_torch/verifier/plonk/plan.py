"""SuccinctPlan: the succinct verifier of one protocol, recorded once as an
Fr program (`ff/fr_tape.py`) and replayed for every batch.  The port's
counterpart of the JAX package's jitted succinct verifier, cached by
`(protocol.content_hash(), scheme, transcript)` as
`parallel/batch_verify.py:94-98` caches its module.

Recording runs `PlonkProof.read` and `PlonkSuccinctVerifier.verify` once
under `TapeLoader` over a recording `TapeTranscript`: the inputs are
symbols for the instances and, in read order, the challenges, z, the
evaluations, mu, gamma and z' (the transcript's squeezes and scalar reads);
the proof's points are stream indices.  A batch reads through a running
`TapeTranscript`, the same class, and `gather` holds its labels to the
tape's inputs.  The plan keeps the tape, each accumulator's
`MsmRecord`s and the protocol points the MSMs name.  It does not depend on
the batch size.

A batch then runs (`sdk/aggregation.py::batch_succinct_verify`):
`read` (the real transcript, its squeezes on the card) -> `gather` (one
(n_in, B, 8) input block, its labels checked) -> `scalars` (one `svt_fr_tape` launch on the
card, `run_plain` on the CPU: the canonical MSM scalars) -> `accumulators`
(the bases the plan names gathered into (B, n, 3, 8), one
`svt_msm_windowed` launch per accumulator side with scaled terms: GWC19's
two sides are two launches, SHPLONK's rhs has none).  An old accumulator the
protocol's instances carry (`TapeLoader.accumulator_from_limbs`) is decoded
from the batch's instance inputs on the device (`pcs/kzg/accumulator.py`).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ...ec.g1 import from_affine_int_np
from ...ff import FQW, fr_tape
from ...loader.msm_expr import lower
from ...loader.tape_loader import GENERATOR, LimbRecord, TapeLoader, TapeTranscript
from ...pcs.kzg.accumulator import accumulator_from_limbs
from .verifier import PlonkSuccinctVerifier

_PLANS: Dict[tuple, "SuccinctPlan"] = {}


def instance_label(c: int, i: int) -> tuple:
    """The tape's input label of instance i of column c (the instances are
    the inputs before the transcript's)."""
    return ("instance", c, i)


class SuccinctPlan:
    def __init__(self, protocol, scheme):
        t0 = time.perf_counter()
        L = TapeLoader()
        instances = [[L.input(instance_label(c, i)) for i in range(n)]
                     for c, n in enumerate(protocol.num_instance)]
        tr = TapeTranscript(L)
        proof = PlonkSuccinctVerifier.read_proof(protocol, instances, tr, scheme, L)
        accs = PlonkSuccinctVerifier.verify(GENERATOR, protocol, instances, proof, scheme, L)
        self.protocol, self.scheme = protocol, scheme
        self.tape = L.finish()
        self.accs = accs  # [(lhs MsmRecord, rhs MsmRecord)] then old accumulators' LimbRecords
        self.const_points = list(L.const_points)
        self.n_points = tr.n_points
        self._bases: Dict[str, torch.Tensor] = {}
        self.record_s = time.perf_counter() - t0

    # ---------------------------------------------------------------- run

    def read(self, instances, transcript, L) -> TapeTranscript:
        """Read one batch's proofs through `transcript` -> the TapeTranscript
        that holds the challenges and scalars, (B, 8) handles in read order.
        `L` only loads the protocol's initial transcript state: the old
        accumulators are decoded once, by `accumulators`."""
        tr = TapeTranscript(inner=transcript)
        PlonkSuccinctVerifier.read_proof(self.protocol, instances, tr, self.scheme, _ReadLoader(L))
        return tr

    def gather(self, instances, tr: TapeTranscript, batch: int):
        """-> the tape's (n_in, B, 8) input block.  Raises ValueError unless
        the reads' labels are the tape's inputs, one for one."""
        labels = [instance_label(c, i) for c, col in enumerate(instances)
                  for i in range(len(col))] + tr.labels
        want = self.tape.inputs
        if labels != want:
            k = next((k for k, (a, b) in enumerate(zip(labels, want)) if a != b),
                     min(len(labels), len(want)))
            raise ValueError(f"plan: the batch's input {k} is {labels[k:k + 1]}, the tape's "
                             f"{want[k:k + 1]} ({len(labels)} inputs read, the tape takes "
                             f"{len(want)})")
        handles = [v for col in instances for v in col] + tr.values
        return torch.stack([h.expand(batch, 8) for h in handles], 0)

    def scalars(self, inputs):
        """-> (n_out, B, 8) canonical MSM scalars: one `svt_fr_tape` launch
        on a CUDA tensor, the plain interpreter on a CPU one."""
        if inputs.device.type == "cuda":
            return fr_tape.run(self.tape, inputs)
        return fr_tape.run_plain(self.tape, inputs)

    def base_table(self, points, g):
        """The bases the MSMs name, (B, m + k + 1, 3, 8): the m stream
        points (Z = 1), the k protocol points (uploaded once per device),
        the generator."""
        B, m = points.shape[:2]
        if points.shape[1] != self.n_points:
            raise ValueError(f"plan: {m} proof points, the protocol reads {self.n_points}")
        dev = points.device
        key = str(dev)
        if key not in self._bases:
            self._bases[key] = (
                torch.from_numpy(from_affine_int_np(self.const_points)).to(dev)
                if self.const_points else torch.empty((0, 3, 8), dtype=torch.int32, device=dev))
        one = FQW.const("ONE", dev).expand(B, m, 1, 8)
        fixed = torch.cat([self._bases[key], g.reshape(1, 3, 8)], 0)
        return torch.cat([torch.cat([points, one], -2), fixed.expand(B, -1, 3, 8)], 1)

    def _base_index(self, src) -> int:
        kind = src[0]
        if kind == "stream":
            return src[1]
        if kind == "const":
            return self.n_points + src[1]
        return self.n_points + len(self.const_points)  # the generator

    def accumulators(self, outs, points, g, inputs) -> List:
        """outs (n_out, B, 8) canonical scalars, points (B, m, 2, 8) the
        stream's affine points, g (3, 8), inputs the (n_in, B, 8) block of
        `gather` -> [(lhs, rhs)], each (B, 3, 8)."""
        table = self.base_table(points, g)
        B, dev = table.shape[0], table.device
        result = []
        for acc in self.accs:
            if isinstance(acc, LimbRecord):
                result.append(accumulator_from_limbs([inputs[k] for k in acc.inputs]))
                continue
            sides = []
            for rec in acc:
                pts = scs = None
                if rec.scaled:
                    rows = torch.tensor([r for r, _ in rec.scaled], device=dev)
                    idx = torch.tensor([self._base_index(s) for _, s in rec.scaled], device=dev)
                    pts = table.index_select(1, idx)
                    scs = outs.index_select(0, rows).transpose(0, 1).contiguous()
                plain = [table[:, self._base_index(s)] for s in rec.plain]
                sides.append(lower(pts, scs, plain, B, dev))
            result.append(tuple(sides))
        return result


class _ReadLoader:
    """`L`'s scalars for `SuccinctPlan.read`, whose proof is dropped: its
    old accumulators are not decoded."""

    def __init__(self, L):
        self.scalar = L.scalar

    @staticmethod
    def accumulator_from_limbs(limbs):
        return None


def succinct_plan(protocol, scheme, scheme_name: str, transcript: str,
                  digest: str = None) -> SuccinctPlan:
    """The plan of (protocol, scheme, transcript), recorded on first use
    and kept for the process.  `digest`: the protocol's content_hash(),
    where the caller has it already."""
    key = (digest or protocol.content_hash(), scheme_name, transcript)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = SuccinctPlan(protocol, scheme)
    return plan
