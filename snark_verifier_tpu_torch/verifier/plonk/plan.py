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

The recording also keeps what the transcript hashes at each squeeze
(`TapeTranscript.squeezes`); for the keccak ("evm") transcript the plan
turns it into a `hash/keccak_device.py::ReadSchedule`: every squeeze's
words, each an instance, the protocol's initial state, a stream scalar, the
x or y of a stream point, the previous hash or the x or y of a lane point,
with its tag.  The schedule depends only on the protocol, so a batch's
whole keccak read is one launch of `svt_keccak_read` (`read_keccak`), whose
challenges a `PrecomputedChallengeTranscript` hands to `read_proof`.

A protocol with an instance committing key (the query-instance family)
commits to each lane's instance columns before the read: the commitment
depends only on the instances and the protocol's points, so
`commit_instances` computes it for the whole batch in one `svt_msm_windowed`
launch over the instances as canonical words (converted on the host,
`sdk/aggregation.py::_instance_block(..., mont=False)`: no launch), and the
read absorbs it as a lane point.  The Poseidon read maps every column's
point Fq -> Fr in one `svt_points_to_fr` launch; the keccak read takes
them as canonical affine Fq words, normalised in one `svt_points_to_fr`
launch (`map_fr=False`), and hashes their x and y where the recording put
them (`keccak_challenges`).  The recording knows it as lane point c of
column c (`TapeLoader.msm_evaluate` without the generator), which the
linearization takes as the column's commitment.

A batch then runs (`sdk/aggregation.py::batch_succinct_verify`):
`read` (the real transcript, its squeezes on the card) or `read_keccak`
(one launch for the whole read) -> `gather` (one
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

import numpy as np
import torch

from ... import errors
from ...device import device_key
from ...ec.g1 import from_affine_int_np
from ...ff import FQW, fr_tape, points_to_fr
from ...hash import keccak_device as kd
from ...loader.msm_expr import MsmExpr, lower
from ...loader.tape_loader import (
    GENERATOR, LanePoint, LimbRecord, TapeLoader, TapeTranscript,
)
from ...msm import cuda_ops
from ...pcs.kzg.accumulator import accumulator_from_limbs
from ...sdk import aot
from ...transcript.evm_transcript import PrecomputedChallengeTranscript
from .verifier import PlonkSuccinctVerifier

_PLANS: Dict[tuple, "SuccinctPlan"] = {}


def instance_label(c: int, i: int) -> tuple:
    """The tape's input label of instance i of column c (the instances are
    the inputs before the transcript's)."""
    return ("instance", c, i)


def keccak_schedule(squeezes, protocol) -> kd.ReadSchedule:
    """A recording's `TapeTranscript.squeezes` -> the keccak read's
    schedule: instances (Fr, Montgomery words in the batch's instance block,
    column by column), constants (hashed as their canonical value), stream
    scalars (Fr), stream points (x and y, Fq), earlier hashes (raw) and lane
    points (x and y, Fq: the committed instance columns).  Raises
    `errors.InvalidProtocol` on any other word."""
    flat = {instance_label(c, i): k for k, (c, i) in enumerate(
        (c, i) for c, n in enumerate(protocol.num_instance) for i in range(n))}
    consts: List[int] = []
    out = []
    for sq in squeezes:
        rows = []
        for kind, v in sq:
            if kind == "const":
                if v not in consts:
                    consts.append(v)
                rows.append((kd.SRC_CONST, consts.index(v), kd.TAG_RAW))
            elif kind == "input" and v in flat:
                rows.append((kd.SRC_INSTANCE, flat[v], kd.TAG_FR))
            elif kind == "scalar":
                rows.append((kd.SRC_SCALAR, v, kd.TAG_FR))
            elif kind == "point":
                rows += [(kd.SRC_POINT_X, v, kd.TAG_FQ), (kd.SRC_POINT_Y, v, kd.TAG_FQ)]
            elif kind == "hash":
                rows.append((kd.SRC_HASH, v, kd.TAG_RAW))
            elif kind == "lane":
                rows += [(kd.SRC_LANE_X, v, kd.TAG_FQ), (kd.SRC_LANE_Y, v, kd.TAG_FQ)]
            else:
                raise errors.InvalidProtocol(f"the keccak read cannot absorb {kind} {v}")
        out.append(rows)
    return kd.ReadSchedule(out, consts)


class SuccinctPlan:
    def __init__(self, protocol, scheme, transcript: str = "poseidon"):
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
        self.n_lanes = len(L.lane_points)  # the committed instance columns
        self.keccak = keccak_schedule(tr.squeezes, protocol) if transcript == "evm" else None
        self._bases: Dict[str, torch.Tensor] = {}
        self.record_s = time.perf_counter() - t0  # or the load's, where `from_cache`
        self.from_cache = False

    # ----------------------------------------------------- the warm start

    def to_record(self) -> aot.Record:
        """The plan as numpy arrays and a JSON header (`sdk/aot.py`): the
        tape, each accumulator's MSM records or limb rows, the keccak
        schedule; the protocol and scheme come from the caller on load."""
        arrays, meta = aot.tape_record(self.tape)
        kinds = []
        for i, acc in enumerate(self.accs):
            if isinstance(acc, LimbRecord):
                kinds.append("limbs")
                arrays[f"acc{i}_limbs"] = np.array(acc.inputs, np.int64)
            else:
                kinds.append("msm")
                for side, rec in zip("lr", acc):
                    arrays.update(aot.msm_arrays(rec, f"acc{i}{side}_"))
        if self.keccak is not None:
            sq = self.keccak.squeezes
            arrays["keccak_words"] = np.array([w for q in sq for w in q], np.int64).reshape(-1, 3)
            arrays["keccak_widths"] = np.array([len(q) for q in sq], np.int64)
        meta.update(accs=kinds, const_points=aot.to_json(self.const_points),
                    n_points=self.n_points, n_lanes=self.n_lanes,
                    keccak_consts=None if self.keccak is None else self.keccak.consts)
        return arrays, meta

    @classmethod
    def from_record(cls, protocol, scheme, transcript: str, arrays, meta) -> "SuccinctPlan":
        t0 = time.perf_counter()
        plan = cls.__new__(cls)
        plan.protocol, plan.scheme = protocol, scheme
        plan.tape = aot.tape_from(arrays, meta)
        plan.accs = []
        for i, kind in enumerate(meta["accs"]):
            if kind == "limbs":
                plan.accs.append(LimbRecord(arrays[f"acc{i}_limbs"].tolist()))
            else:
                plan.accs.append(tuple(aot.msm_from(arrays, f"acc{i}{side}_") for side in "lr"))
        plan.const_points = aot.from_json(meta["const_points"])
        plan.n_points, plan.n_lanes = int(meta["n_points"]), int(meta["n_lanes"])
        plan.keccak = None
        if transcript == "evm":
            words = arrays["keccak_words"].tolist()
            ends = np.cumsum(arrays["keccak_widths"]).tolist()
            plan.keccak = kd.ReadSchedule([words[e - w:e] for e, w in
                                           zip(ends, arrays["keccak_widths"].tolist())],
                                          meta["keccak_consts"])
        plan._bases = {}
        plan.record_s, plan.from_cache = time.perf_counter() - t0, True
        return plan

    # ---------------------------------------------------------------- run

    def commit(self, inst_plain):
        """The lane points of one batch: `commit_instances` for a protocol
        with an instance committing key, else None."""
        if self.protocol.instance_committing_key is None:
            return None
        return commit_instances(self.protocol, inst_plain)

    def read(self, instances, transcript, L) -> TapeTranscript:
        """Read one batch's proofs through `transcript` -> the TapeTranscript
        that holds the challenges and scalars, (B, 8) handles in read order.
        `L` only loads the protocol's initial transcript state: the old
        accumulators are decoded once, by `accumulators`; the committed
        instances are the transcript's lane points (`commit`)."""
        return read_proof(self.protocol, self.scheme, instances, transcript, L)

    def read_keccak(self, inst, instances, scalars, points, L, lanes=None) -> TapeTranscript:
        """The keccak read of one batch (`keccak_challenges` over the
        instance block inst (B, n_inst, 8), the streams and the lane points
        of `commit`), then `read` over a transcript that replays its
        challenges."""
        if self.keccak is None:
            raise ValueError("plan: recorded for another transcript than keccak")
        chals = keccak_challenges(self.keccak, inst, scalars, points, lanes)
        return self.read(instances, PrecomputedChallengeTranscript(scalars, points, list(chals)),
                         L)

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

    def base_table(self, points, g, lanes=None):
        """The bases the MSMs name, (B, m + l + k + 1, 3, 8): the m stream
        points (Z = 1), the l lane points, the k protocol points (uploaded
        once per device), the generator."""
        B, m = points.shape[:2]
        if points.shape[1] != self.n_points:
            raise ValueError(f"plan: {m} proof points, the protocol reads {self.n_points}")
        if (0 if lanes is None else lanes.shape[1]) != self.n_lanes:
            raise ValueError(f"plan: the protocol commits {self.n_lanes} instance columns")
        dev = points.device
        key = device_key(dev)
        if key not in self._bases:
            self._bases[key] = (
                torch.from_numpy(from_affine_int_np(self.const_points)).to(dev)
                if self.const_points else torch.empty((0, 3, 8), dtype=torch.int32, device=dev))
        one = FQW.const("ONE", dev).expand(B, m, 1, 8)
        fixed = torch.cat([self._bases[key], g.reshape(1, 3, 8)], 0)
        parts = [torch.cat([points, one], -2)] + ([] if lanes is None else [lanes])
        return torch.cat(parts + [fixed.expand(B, -1, 3, 8)], 1)

    def _base_index(self, src) -> int:
        kind = src[0]
        if kind == "stream":
            return src[1]
        if kind == "lane":
            return self.n_points + src[1]
        if kind == "const":
            return self.n_points + self.n_lanes + src[1]
        return self.n_points + self.n_lanes + len(self.const_points)  # the generator

    def accumulators(self, outs, points, g, inputs, lanes=None) -> List:
        """outs (n_out, B, 8) canonical scalars, points (B, m, 2, 8) the
        stream's affine points, g (3, 8), inputs the (n_in, B, 8) block of
        `gather`, lanes the (B, l, 3, 8) lane points of `commit` -> [(lhs,
        rhs)], each (B, 3, 8)."""
        table = self.base_table(points, g, lanes)
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
    """`L`'s scalars for `read_proof`, whose proof is dropped: its old
    accumulators are not decoded, and its instance commitments are the
    lane points 0, 1, ... (computed before the read: `commit_instances`),
    which the transcript absorbs as such."""

    def __init__(self, L):
        self.scalar = L.scalar
        self._lanes = 0

    @staticmethod
    def accumulator_from_limbs(limbs):
        return None

    def msm_base_int(self, pt):
        return MsmExpr.base(self, None)

    def msm_sum(self, exprs):
        return MsmExpr.sum(self, exprs)

    def msm_evaluate(self, expr, g=None):
        self._lanes += 1
        return LanePoint(self._lanes - 1)

    @staticmethod
    def affine(pt):
        return pt


def read_proof(protocol, scheme, instances, transcript, L) -> TapeTranscript:
    """`PlonkProof.read` of one batch through `transcript` (which holds the
    batch's lane points, if the protocol commits its instances) -> the
    TapeTranscript of the reads' values in read order."""
    tr = TapeTranscript(inner=transcript)
    PlonkSuccinctVerifier.read_proof(protocol, instances, tr, scheme, _ReadLoader(L))
    return tr


def keccak_challenges(schedule: kd.ReadSchedule, inst, scalars, points, lanes=None):
    """Every challenge of a batch's keccak read, (n_sq, B, 8) Fr Montgomery
    words: the lane points (B, l, 3, 8) projective (None: none) normalised
    to canonical affine Fq words in one `svt_points_to_fr` launch
    (`map_fr=False`; the identity is (0, 0), as the JAX package's
    `G1.to_affine`), then one `svt_keccak_read` launch over the instance
    block, the streams and those points (`read_plain` on CPU tensors)."""
    xy = None if lanes is None else points_to_fr(lanes.contiguous(), projective=True,
                                                 map_fr=False)
    return kd.read(schedule, inst, scalars, points, xy)[1]


def _ick_bases(points, device):
    """The instance committing key's points as (n, 3, 8) words on `device`,
    uploaded once per (points, device)."""
    key = (tuple(points), device_key(device))
    t = _ICK_BASES.get(key)
    if t is None:
        t = _ICK_BASES[key] = torch.from_numpy(from_affine_int_np(list(points))).to(device)
    return t


_ICK_BASES: Dict[tuple, torch.Tensor] = {}


def commit_instances(protocol, inst_plain):
    """The instance committing key's commitment to every lane's instance
    columns: column c of lane b is Σᵢ bases[i]·instances[b][c][i] (+ the
    key's constant point).  inst_plain (B, n_inst, 8): the instances as
    canonical plain words, column by column -> (B, n_col, 3, 8) projective
    words, from one `svt_msm_windowed` launch over (B·n_col, n + 1) terms:
    the bases (a shorter column's scalars padded with zeros) and the
    constant with the scalar 1.  A column with no term is the identity."""
    ick = protocol.instance_committing_key
    bases, const = list(ick["bases"]), ick.get("constant")
    counts = [min(n, len(bases)) for n in protocol.num_instance]
    B, dev = inst_plain.shape[0], inst_plain.device
    n = max(counts, default=0)
    width = n + (const is not None)
    if width == 0:
        return cuda_ops.identity((B, len(counts)), dev).contiguous()
    scs = torch.zeros((B, len(counts), width, 8), dtype=torch.int32, device=dev)
    k = 0
    for c, (cnt, ncol) in enumerate(zip(counts, protocol.num_instance)):
        scs[:, c, :cnt] = inst_plain[:, k : k + cnt]
        k += ncol
    if const is not None:
        scs[:, :, n, 0] = 1
    pts = _ick_bases(bases[:n] + ([const] if const is not None else []), dev)
    pts = pts.expand(B * len(counts), width, 3, 8).contiguous()
    out = cuda_ops.msm_windowed(pts, scs.view(B * len(counts), width, 8), c=4)
    return out.view(B, len(counts), 3, 8)


def succinct_plan(protocol, scheme, scheme_name: str, transcript: str,
                  digest: str = None, device=None) -> SuccinctPlan:
    """The plan of (protocol, scheme, transcript), recorded on first use
    and kept for the process; where the warm-start cache is on for
    `device` (`sdk/aot.py`), loaded from it, or recorded and saved to it.
    `digest`: the protocol's content_hash(), where the caller has it
    already."""
    key = (digest or protocol.content_hash(), scheme_name, transcript)
    plan = _PLANS.get(key)
    if plan is None:
        build = lambda: SuccinctPlan(protocol, scheme, transcript)
        if aot.enabled(device):
            plan = aot.load_or_compile(
                ("succinct_plan",) + key, build, SuccinctPlan.to_record,
                lambda arrays, meta: SuccinctPlan.from_record(protocol, scheme, transcript,
                                                              arrays, meta))
        else:
            plan = build()
        _PLANS[key] = plan
    return plan
