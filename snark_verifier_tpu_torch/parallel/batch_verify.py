"""Batch verification: the succinct phase, then the pairing decide, one
accept bit per proof.  The counterpart of the JAX package's
`parallel/batch_verify.py` (`batch_succinct_verify_sharded` :55,
`batch_decide_sharded` :113, `batch_verify_sharded` :136).

The sharded functions split the batch over a mesh axis (`mesh.Mesh`): each
device verifies its shard through the port's one-device path
(`sdk.aggregation.batch_succinct_verify`, `pcs.kzg.decider.decide_all`),
and a shard's accumulators stay on its device between the two phases.
Verification is data-parallel, so nothing is gathered; the accept bits
come back on the mesh's first device.  The shards are dispatched one after
another from the host.  `batch_verify` is the same path on a mesh of one
device.

The JAX package caches each compiled phase (`_cached` :35) and, on a TPU,
shares it across processes through `sdk/aot.py`; the port's counterpart is
the recorded plan of `verifier/plonk/plan.py::succinct_plan`, cached in the
process and, through `sdk/aot.py`, across processes.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch

from .._launch import COUNTERS
from ..device import resolve_device
from ..pcs.kzg.decider import decide_all
from ..sdk.aggregation import batch_succinct_verify
from ..sdk.snark import Snark
from ..utils.timing import _step
from .mesh import Mesh, assemble, split


def batch_verify(snarks: Sequence, srs, scheme_name: str = "shplonk",
                 transcript: str = "poseidon", device=None, timings: dict = None):
    """Verify B same-protocol snarks on `device` (None: the CUDA card) ->
    (B,) bool on that device: `batch_verify_sharded` on a mesh of that one
    device, with its `timings`.  Supported: the schemes "shplonk" (SHPLONK)
    and "gwc" (GWC19), each with the transcripts "poseidon" and "evm"
    (keccak); anything else raises ValueError.  Every accumulator a proof
    yields (the fresh one and any old ones its instances carry) must pass
    for the proof to be accepted; a proof that `Snark.validate` refuses (a
    point off the curve, a value not reduced, an old accumulator that
    decodes off the curve) is answered False in its own lane."""
    return batch_verify_sharded(snarks, srs, Mesh([resolve_device(device)], ("batch",)),
                                scheme_name, timings=timings, transcript=transcript)


def batch_succinct_verify_sharded(snarks: Sequence, srs, mesh: Mesh,
                                  scheme_name: str = "shplonk", axis_name: str = "batch",
                                  transcript: str = "poseidon",
                                  timings: dict = None) -> List[List]:
    """The succinct phase, the batch split over mesh axis `axis_name` (B
    must divide by its size) -> one list a shard, in mesh order, of that
    shard's (lhs, rhs) accumulators, each (B / D, 3, 8) on the shard's
    device.  `timings`, when given, gets the succinct phase's steps
    (`sdk.aggregation.batch_succinct_verify`), summed over the shards.

    The per-shard form is deliberate: the JAX package returns one (lhs,
    rhs) a proof's accumulator as arrays sharded over the axis, and torch
    has no sharded array.  Assembling each accumulator whole would copy
    every shard's to the first device and back for the decide; kept per
    shard, the accumulators never leave their device.
    `batch_decide_sharded` takes this form, and concatenating the shards'
    lists lane-wise gives the one-device batch's accumulators."""
    if not snarks:
        raise ValueError("batch_succinct_verify_sharded: empty batch")
    line = mesh.along(axis_name)
    return [batch_succinct_verify(part, srs, scheme_name, transcript, device=dev,
                                  timings=timings)
            for part, dev in zip(split(list(snarks), line, axis_name), line.devices.flat)]


def batch_decide_sharded(accumulators: List[List], srs, mesh: Mesh,
                         axis_name: str = "batch"):
    """The pairing decide of each shard's accumulators on its own device ->
    (B,) bool on the mesh's first device: a lane accepts when all its
    accumulators pass.  `accumulators` is the per-shard form that
    `batch_succinct_verify_sharded` returns (one list a shard, not the JAX
    package's sharded arrays: torch has none), so no accumulator is
    copied between devices; only the accept bits are assembled."""
    line = mesh.along(axis_name)
    if len(accumulators) != line.size:
        raise ValueError(f"batch_decide_sharded: {len(accumulators)} shards for "
                         f"{line.size} devices")
    return assemble([decide_all(srs, accs).all(dim=0) for accs in accumulators], line)


def _screen(snarks: Sequence, device):
    """The per-lane validation screen (`Snark.screen_all`: `validate`,
    memoized on each lane) -> (lanes, valid).  `lanes` is the
    batch with each lane that fails the screen replaced by the batch's
    first lane that passes, so the batch keeps its size and the shapes it
    was warmed with; None where no lane passes.  `valid` is the (B,) bool
    of the lanes that pass, on `device` (sent from pinned memory without a
    wait), or None where every lane passes.  Each failing lane is one count
    of `COUNTERS["lanes_invalid"]`, a key that appears with the first one
    after a `reset_launches()`."""
    ok = Snark.screen_all(snarks)
    if False not in ok:
        return snarks, None
    bad = ok.count(False)
    COUNTERS["lanes_invalid"] = COUNTERS.get("lanes_invalid", 0) + bad
    host = torch.tensor(ok, dtype=torch.bool)
    valid = (host.pin_memory() if device.type == "cuda" else host).to(device, non_blocking=True)
    if bad == len(snarks):
        return None, valid
    stand_in = snarks[ok.index(True)]
    return [s if v else stand_in for s, v in zip(snarks, ok)], valid


def batch_verify_sharded(snarks: Sequence, srs, mesh: Mesh, scheme_name: str = "shplonk",
                         axis_name: str = "batch", timings: dict = None,
                         transcript: str = "poseidon"):
    """-> (B,) bool on the mesh's first device; B must divide by the size of
    mesh axis `axis_name`.  The schemes "shplonk" and "gwc", each with the
    transcripts "poseidon" and "evm" (instance-committing-key protocols and
    old accumulators included).  A lane that `Snark.validate` refuses is
    answered False and the others are verified as before (`_screen`); a
    batch with no valid lane launches nothing.  The call is the span
    "svt::verify", its phases "svt::verify.screen", "svt::verify.succinct"
    and "svt::verify.decide" (`utils.timing`).  `timings`, when given, gets
    `succinct_s` and `decide_s`, host seconds of each phase over every
    shard, each ended by a synchronize of every device, the succinct
    phase's steps summed over the shards, and `screen_s` where the screen
    refused a lane (a batch of valid lanes records the keys it did
    before the screen)."""

    def call():
        if timings is not None:
            mesh.synchronize()
        t = time.perf_counter()
        lanes, valid = _step("verify.screen", lambda: _screen(snarks, mesh.first))
        if timings is not None and valid is not None:  # a batch with lanes the screen refused
            mesh.synchronize()
            timings["screen_s"] = timings.get("screen_s", 0.0) + time.perf_counter() - t
        if lanes is None:
            return valid
        accs = _step("verify.succinct", lambda: batch_succinct_verify_sharded(
            lanes, srs, mesh, scheme_name, axis_name, transcript, timings),
            timings, "succinct_s", mesh)
        ok = _step("verify.decide", lambda: batch_decide_sharded(accs, srs, mesh, axis_name),
                   timings, "decide_s", mesh)
        return ok if valid is None else ok & valid

    return _step("verify", call)
