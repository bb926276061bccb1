"""Batch verification on one card: the succinct phase, then the pairing
decide, one accept bit per proof.  The counterpart of the JAX package's
`parallel/batch_verify.py::batch_verify_sharded` (:136-152) on a single
device: no mesh and no sharding (several cards are later work).
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..device import resolve_device
from ..pcs.kzg.decider import decide_all
from ..sdk.aggregation import batch_succinct_verify


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_verify(snarks: Sequence, srs, scheme_name: str = "shplonk",
                 transcript: str = "poseidon", device=None, timings: dict = None):
    """Verify B same-protocol snarks on `device` (None: the CUDA card) ->
    (B,) bool on that device.  `timings`, when given, gets `succinct_s` and
    `decide_s`: host seconds of each phase, each ended by a synchronize,
    and the succinct phase's steps (`sdk.aggregation.batch_succinct_verify`).
    Supported: the schemes "shplonk" (SHPLONK) and "gwc" (GWC19) with the
    transcript "poseidon"; any other pair raises ValueError.  Every
    accumulator a proof yields (the fresh one and any old ones its
    instances carry) must pass for the proof to be accepted."""
    dev = resolve_device(device)
    t0 = time.time()
    accs = batch_succinct_verify(snarks, srs, scheme_name, transcript, device=dev,
                                 timings=timings)
    _sync(dev)
    t1 = time.time()
    oks = decide_all(srs, accs).all(dim=0)
    _sync(dev)
    if timings is not None:
        timings["succinct_s"] = t1 - t0
        timings["decide_s"] = time.time() - t1
    return oks
