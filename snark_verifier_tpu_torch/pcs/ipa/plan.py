"""IpaPlan: the IPA family's succinct verifiers recorded once per shape and
replayed for every batch, the port's counterpart of the JAX package's
jitted IPA verify (its tests jit `Ipa.succinct_verify`, `IpaAs.verify` and
`Bgh19.verify` over one proof each).

A plan records one of three verifiers under `TapeLoader` over a recording
`TapeTranscript`: `Ipa.succinct_verify` ("ipa": one opening p(z) = v of a
commitment C), `IpaAs.verify` ("as": N accumulators folded by a fresh IPA)
or `Bgh19.verify` ("bgh19": a multiopen).  Its key is (kind, the verifying
key, the shape: N accumulators or the BGH19 queries' (poly, shift)).  The
inputs of the tape are the batch's given scalars (z and v; the
accumulators' ξ; x and the query evaluations) and then the transcript's
reads; C, each accumulator's U and each BGH19 commitment are lane points,
(B, 3, 8) projective words handed in at run time.

A batch then runs (`run`):
  1. `read`: the real Poseidon transcript over the batch's streams (one
     `svt_points_to_fr` launch maps the stream points, one more the lane
     points where the verifier absorbs them: IpaAs's U's; one
     `svt_poseidon_absorb` launch a squeeze);
  2. `gather`: the given scalars and the reads as one (n_in, B, 8) block,
     its labels held to the tape's inputs;
  3. one `svt_fr_tape` launch: ξ⁻¹ by one batch inversion, h(z), v' =
     h(z)·c, the powers of α, BGH19's two batch inversions, every MSM
     scalar as a canonical word;
  4. one `svt_msm_windowed` launch for lhs − rhs over the stream points,
     the lane points and the key's points (coefficient-1 terms with the
     scalar 1), and the accept bit "lhs − rhs is the identity" as word
     comparisons on the card (`cuda_ops.is_identity`): no host loop.
The result is each lane's accumulator (ξ (B, k, 8) Montgomery words, U (B,
3, 8) projective with Z = 1) and its accept bit (B,).

The batch entry points (`batch_ipa_verify`, `batch_ipa_as_verify`,
`batch_bgh19_verify`) take host proofs (`IpaOpening`, `IpaFold`,
`Bgh19Opening`: python ints, each with its key), refuse a batch whose
lanes carry different keys or shapes, stack and upload them, and run the
plan.  On a CPU device every kernel step runs its plain version.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import device_key, resolve_device
from ...ec.g1 import from_affine_int_np
from ...ff import FQW, FRW, fr_tape
from ...loader.tape_loader import (
    IdentityRecord, LanePoint, StreamPoint, TapeLoader, TapeTranscript,
)
from ...msm import cuda_ops
from ...sdk import aot
from ...transcript.poseidon_transcript import PoseidonTranscript
from ...utils.timing import _step
from ..kzg.multiopen import Query
from .bgh19 import Bgh19
from .ipa import Ipa, IpaAccumulator, IpaAs, IpaSuccinctVerifyingKey, _mont_words

KINDS = ("ipa", "as", "bgh19")
_PLANS: Dict[tuple, "IpaPlan"] = {}


class _RunLoader:
    """What the reads take from a loader when a batch runs: lane points
    pass to the transcript as they are."""

    @staticmethod
    def affine(pt):
        return pt


class IpaPlan:
    def __init__(self, kind: str, svk: IpaSuccinctVerifyingKey, shape: tuple = ()):
        """shape: () for "ipa", (N,) for "as", the queries' ((poly, shift),
        ...) for "bgh19"."""
        if kind not in KINDS:
            raise ValueError(f"IpaPlan: kind {kind!r}, not one of {KINDS}")
        t0 = time.perf_counter()
        self.kind, self.svk, self.shape = kind, svk, tuple(shape)
        L = TapeLoader()
        given = [L.input(label) for label in self._given_labels()]
        lanes = [L.lane_point() for _ in range(self.n_lanes)]
        tr = TapeTranscript(L)
        proof = self._read(tr, L, given, lanes)
        acc, ok = self._verify(L, given, lanes, proof)
        if not isinstance(ok, IdentityRecord):
            raise TypeError("IpaPlan: the verifier's accept bit is not an identity check")
        self.tape = L.finish()
        self.check = ok.msm
        self.xi_rows = [x.ref[1] for x in acc.xi]  # the challenges' input rows
        if not isinstance(acc.u, StreamPoint):
            raise TypeError("IpaPlan: the accumulator's U is not a proof point")
        self.u_index = acc.u.index
        self.n_given = len(given)
        self.n_points, self.n_scalars = tr.n_points, tr.n_scalars
        self.const_points = list(L.const_points)
        self._bases: Dict[str, torch.Tensor] = {}
        self.record_s = time.perf_counter() - t0  # or the load's, where `from_cache`
        self.from_cache = False

    def to_record(self) -> aot.Record:
        """The plan as numpy arrays and a JSON header (`sdk/aot.py`); the
        kind, key and shape come from the caller on load."""
        arrays, meta = aot.tape_record(self.tape)
        arrays.update(aot.msm_arrays(self.check, "check_"))
        arrays["xi_rows"] = np.array(self.xi_rows, np.int64)
        meta.update(u_index=self.u_index, n_given=self.n_given, n_points=self.n_points,
                    n_scalars=self.n_scalars, const_points=aot.to_json(self.const_points))
        return arrays, meta

    @classmethod
    def from_record(cls, kind, svk, shape, arrays, meta) -> "IpaPlan":
        t0 = time.perf_counter()
        plan = cls.__new__(cls)
        plan.kind, plan.svk, plan.shape = kind, svk, tuple(shape)
        plan.tape = aot.tape_from(arrays, meta)
        plan.check = aot.msm_from(arrays, "check_")
        plan.xi_rows = arrays["xi_rows"].tolist()
        plan.u_index, plan.n_given = int(meta["u_index"]), int(meta["n_given"])
        plan.n_points, plan.n_scalars = int(meta["n_points"]), int(meta["n_scalars"])
        plan.const_points = aot.from_json(meta["const_points"])
        plan._bases = {}
        plan.record_s, plan.from_cache = time.perf_counter() - t0, True
        return plan

    # ------------------------------------------------------------- shapes

    @property
    def n_lanes(self) -> int:
        if self.kind == "ipa":
            return 1
        if self.kind == "as":
            return self.shape[0]
        return 1 + max(p for p, _ in self.shape)

    def _given_labels(self) -> List[tuple]:
        if self.kind == "ipa":
            return [("z",), ("eval",)]
        if self.kind == "as":
            return [("acc_xi", n, i) for n in range(self.shape[0]) for i in range(self.svk.k)]
        return [("x",)] + [("eval", j) for j in range(len(self.shape))]

    def _accs(self, given, lanes) -> List[IpaAccumulator]:
        k = self.svk.k
        return [IpaAccumulator(given[n * k : (n + 1) * k], lanes[n]) for n in range(len(lanes))]

    def _queries(self, given) -> List[Query]:
        return [Query(p, sh, given[1 + j]) for j, (p, sh) in enumerate(self.shape)]

    def _read(self, tr, L, given, lanes):
        if self.kind == "ipa":
            return Ipa.read_proof(self.svk, tr)
        if self.kind == "as":
            return IpaAs.read_proof(self.svk, self._accs(given, lanes), tr, L)
        return Bgh19.read_proof(self.svk, self._queries(given), tr)

    def _verify(self, L, given, lanes, proof):
        if self.kind == "ipa":
            return Ipa.succinct_verify(self.svk, L.msm_base_proj(lanes[0]), given[0], given[1],
                                       proof, L)
        if self.kind == "as":
            return IpaAs.verify(self.svk, self._accs(given, lanes), proof, L)
        return Bgh19.verify(self.svk, [L.msm_base_proj(c) for c in lanes], given[0],
                            self._queries(given), proof, L)

    # ---------------------------------------------------------------- run

    def read(self, given, scalars, points, lanes) -> TapeTranscript:
        """The batch's Poseidon read -> the TapeTranscript of its values.
        given (B, n_given, 8) Montgomery words, scalars (B, n, 8), points
        (B, m, 2, 8), lanes (B, n_lanes, 3, 8)."""
        dev = given.device
        tr = TapeTranscript(inner=PoseidonTranscript(scalars, points, dev, lanes=lanes))
        self._read(tr, _RunLoader, [given[:, i] for i in range(given.shape[1])],
                   [LanePoint(k) for k in range(self.n_lanes)])
        return tr

    def gather(self, given, tr: TapeTranscript):
        """-> the tape's (n_in, B, 8) input block."""
        labels = self._given_labels() + tr.labels
        if labels != self.tape.inputs:
            raise ValueError(f"IpaPlan: the batch's inputs {len(labels)} do not match the "
                             f"tape's {len(self.tape.inputs)}")
        B = given.shape[0]
        return torch.cat([given.transpose(0, 1),
                          torch.stack([v.expand(B, 8) for v in tr.values], 0)], 0).contiguous()

    def scalars(self, inputs):
        if inputs.device.type == "cuda":
            return fr_tape.run(self.tape, inputs)
        return fr_tape.run_plain(self.tape, inputs)

    def _const_table(self, device):
        key = device_key(device)
        if key not in self._bases:
            self._bases[key] = torch.from_numpy(from_affine_int_np(self.const_points)).to(device)
        return self._bases[key]

    def _base_index(self, src) -> int:
        kind, k = src
        if kind == "stream":
            return k
        if kind == "lane":
            return self.n_points + k
        if kind == "const":
            return self.n_points + self.n_lanes + k
        raise ValueError(f"IpaPlan: no base source {src}")

    def accept(self, outs, points, lanes):
        """One `svt_msm_windowed` launch for lhs − rhs (the scaled terms
        with their tape outputs, the coefficient-1 terms with the scalar
        1) -> ((B,) accept bits, the (B, m + l + k, 3, 8) base table)."""
        B, m, dev = points.shape[0], points.shape[1], points.device
        one = FQW.const("ONE", dev).expand(B, m, 1, 8)
        table = torch.cat([torch.cat([points, one], -2), lanes,
                           self._const_table(dev).expand(B, -1, 3, 8)], 1)
        rec = self.check
        idx = torch.tensor([self._base_index(s) for _, s in rec.scaled]
                           + [self._base_index(s) for s in rec.plain], device=dev)
        rows = torch.tensor([r for r, _ in rec.scaled], device=dev)
        scs = outs.index_select(0, rows).transpose(0, 1)
        if rec.plain:
            ones = FRW.const("ONE_PLAIN", dev).expand(B, len(rec.plain), 8)
            scs = torch.cat([scs, ones], 1)
        diff = cuda_ops.msm_windowed(table.index_select(1, idx), scs.contiguous(), c=4)
        return cuda_ops.is_identity(diff), table

    def run(self, given, scalars, points, lanes, timings: Optional[dict] = None):
        """-> (IpaAccumulator(ξ (B, k, 8), U (B, 3, 8)), accept (B,) bool)."""
        dev = given.device
        if scalars.shape[1] != self.n_scalars or points.shape[1] != self.n_points:
            raise ValueError(f"IpaPlan: {scalars.shape[1]} scalars and {points.shape[1]} points, "
                             f"the proof has {self.n_scalars} and {self.n_points}")
        if given.shape[1] != self.n_given or lanes.shape[1] != self.n_lanes:
            raise ValueError(f"IpaPlan: {given.shape[1]} scalars and {lanes.shape[1]} points "
                             f"given, the plan takes {self.n_given} and {self.n_lanes}")
        tr = _step("ipa.read", lambda: self.read(given, scalars, points, lanes), timings, "read_s",
                   dev)
        inputs = _step("ipa.gather", lambda: self.gather(given, tr), timings, "gather_s", dev)
        outs = _step("ipa.fr_tape", lambda: self.scalars(inputs), timings, "fr_tape_s", dev)
        ok, table = _step("ipa.msm", lambda: self.accept(outs, points, lanes), timings, "msm_s",
                          dev)
        xi = inputs[self.xi_rows].transpose(0, 1)
        return IpaAccumulator(xi, table[:, self.u_index]), ok


def ipa_plan(kind: str, svk: IpaSuccinctVerifyingKey, shape: tuple = (),
             device=None) -> IpaPlan:
    """The plan of (kind, key, shape), recorded on first use and kept for
    the process; where the warm-start cache is on for `device`
    (`sdk/aot.py`), loaded from it, or recorded and saved to it."""
    key = (kind, svk.key(), tuple(shape))
    plan = _PLANS.get(key)
    if plan is None:
        build = lambda: IpaPlan(kind, svk, shape)
        if aot.enabled(device):
            plan = aot.load_or_compile(
                ("ipa_plan",) + key, build, IpaPlan.to_record,
                lambda arrays, meta: IpaPlan.from_record(kind, svk, shape, arrays, meta))
        else:
            plan = build()
        _PLANS[key] = plan
    return plan


# ------------------------------------------------------------ host proofs


def _point_words(points) -> np.ndarray:
    """Affine int tuples -> (m, 2, 8) Fq Montgomery words."""
    if not points:
        return np.zeros((0, 2, 8), np.int32)
    return np.ascontiguousarray(from_affine_int_np(list(points))[:, :2])


def _proj_words(points) -> np.ndarray:
    return from_affine_int_np(list(points))


@dataclass
class IpaOpening:
    """One IPA opening p(z) = v of the commitment c (affine ints), its proof
    the streams the prover wrote (`PoseidonTranscriptPy.streams`)."""

    svk: IpaSuccinctVerifyingKey
    c: Tuple
    z: int
    v: int
    scalars: List[int]
    points: List[Tuple]

    def shape(self) -> tuple:
        return ()

    @functools.cached_property
    def host(self):
        """(given, lanes, scalars, points) as numpy words, made once."""
        return (_mont_words([self.z, self.v]), _proj_words([self.c]),
                _mont_words(self.scalars), _point_words(self.points))


@dataclass
class IpaFold:
    """An IpaAs proof folding `accs` (host-int IpaAccumulators)."""

    svk: IpaSuccinctVerifyingKey
    accs: List[IpaAccumulator]
    scalars: List[int]
    points: List[Tuple]

    def shape(self) -> tuple:
        return (len(self.accs),)

    @functools.cached_property
    def host(self):
        return (_mont_words([x for a in self.accs for x in a.xi]),
                _proj_words([a.u for a in self.accs]),
                _mont_words(self.scalars), _point_words(self.points))


@dataclass
class Bgh19Opening:
    """A BGH19 multiopen: the polynomials' commitments, the point x and the
    queries (poly, shift, eval) as ints."""

    svk: IpaSuccinctVerifyingKey
    commitments: List[Tuple]
    x: int
    queries: List[Tuple[int, int, int]]
    scalars: List[int]
    points: List[Tuple]

    def shape(self) -> tuple:
        return tuple((p, sh) for p, sh, _ in self.queries)

    @functools.cached_property
    def host(self):
        return (_mont_words([self.x] + [ev for _, _, ev in self.queries]),
                _proj_words(self.commitments), _mont_words(self.scalars),
                _point_words(self.points))


def _batch(kind: str, items: Sequence, device, timings):
    if not items:
        raise ValueError(f"batch {kind} verify: empty batch")
    dev = resolve_device(device)

    def lookup():
        firsts = {id(it.svk): it for it in items}  # tiled batches share objects
        keys = {it.svk.key() for it in firsts.values()}
        shapes = {it.shape() for it in {id(it): it for it in items}.values()}
        if len(keys) != 1 or len(shapes) != 1:
            raise ValueError(f"a {kind} batch verifies under one key and one proof shape: "
                             f"{len(keys)} keys and {len(shapes)} shapes")
        return ipa_plan(kind, items[0].svk, shapes.pop(), device=dev)

    plan = _step("ipa.plan", lookup, timings, "plan_s", dev)

    def stack():
        hosts = [it.host for it in items]
        return tuple(torch.from_numpy(np.stack([h[i] for h in hosts], 0)).to(dev)
                     for i in range(4))

    given, lanes, sc, pts = _step("ipa.stack", stack, timings, "stack_s", dev)
    return plan.run(given, sc, pts, lanes, timings)


def batch_ipa_verify(openings: Sequence[IpaOpening], device=None, timings: dict = None):
    """B IPA openings under one key -> (IpaAccumulator(ξ (B, k, 8), U (B, 3,
    8)), accept (B,) bool) on `device` (None: the CUDA card).  `timings`
    gets each step's host seconds between synchronizes: `plan_s`,
    `stack_s`, `read_s`, `gather_s`, `fr_tape_s`, `msm_s`."""
    return _batch("ipa", openings, device, timings)


def batch_ipa_as_verify(folds: Sequence[IpaFold], device=None, timings: dict = None):
    """B IpaAs folds of N accumulators each -> the folded accumulators and
    the accept bits, as `batch_ipa_verify`."""
    return _batch("as", folds, device, timings)


def batch_bgh19_verify(openings: Sequence[Bgh19Opening], device=None, timings: dict = None):
    """B BGH19 multiopens of one query shape -> the accumulators and the
    accept bits, as `batch_ipa_verify`."""
    return _batch("bgh19", openings, device, timings)
