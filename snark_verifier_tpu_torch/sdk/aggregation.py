"""Batched succinct verification: the counterpart of the JAX package's
`sdk/aggregation.py` (`_stack_streams` :40, `_stack_instances` :50,
`batch_succinct_verify` :80).

B snarks of one protocol verify as one batch on one device: their streams
are stacked on the host and uploaded once per stream, the Poseidon
transcript reads the proofs (one `svt_poseidon_absorb` launch per
challenge), the protocol's recorded Fr program (`verifier/plonk/plan.py`)
runs as one `svt_fr_tape` launch, and the MSM as one `svt_msm_windowed`
launch.  The result is each proof's KZG accumulator, to be decided by
pairings.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ff import np_limbs_to_words
from ..ff.spec import FR, int_to_limbs
from ..loader.base import TorchLoader
from ..pcs.kzg.multiopen import Bdfg21
from ..transcript.poseidon_transcript import PoseidonTranscript
from ..verifier.plonk.plan import succinct_plan
from .snark import Snark

SCHEMES = {"shplonk": Bdfg21}
TRANSCRIPTS = {"poseidon": PoseidonTranscript}


def _stack_streams(snarks: Sequence[Snark], device):
    """-> scalars (B, n, 8), points (B, m, 2, 8) words: one upload each."""
    pairs = [s.host_streams() for s in snarks]
    sc = torch.from_numpy(np.stack([p[0] for p in pairs], 0)).to(device)
    pts = torch.from_numpy(np.stack([p[1] for p in pairs], 0)).to(device)
    return sc, pts


def _stack_instances(snarks: Sequence[Snark], device):
    """-> a list (per instance column) of lists of (B, 8) Fr words, from one
    host block and one upload."""
    p, R = FR.p, 1 << 256
    num_instance = snarks[0].protocol.num_instance
    flat = np.zeros((len(snarks), sum(num_instance), 16), np.uint32)
    for b, s in enumerate(snarks):
        vals = [v for col in s.instances for v in col]
        for k, v in enumerate(vals):
            flat[b, k] = int_to_limbs((v % p) * R % p)
    flat_dev = torch.from_numpy(np_limbs_to_words(flat)).to(device)
    out, k = [], 0
    for ncol in num_instance:
        out.append([flat_dev[:, k + i] for i in range(ncol)])
        k += ncol
    return out


def _step(timings, key: str, device, fn):
    """fn(); with `timings`, its host seconds under `key`, between two
    synchronizes of `device`."""
    if timings is None:
        return fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    r = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[key] = time.perf_counter() - t
    return r


def batch_succinct_verify(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                          transcript: str = "poseidon", device=None, timings: dict = None):
    """One batched succinct verification of B same-protocol snarks on
    `device` (None: the CUDA card).  Returns the list of (lhs, rhs)
    accumulators, each (B, 3, 8) projective G1 words.  The protocol's Fr
    program is recorded on its first batch in this process and replayed
    (`verifier/plonk/plan.py`).

    `timings`, when given, gets each step's host seconds, each step between
    two synchronizes: `stack_s` (stack and upload), `plan_s` (the protocol
    check and the plan lookup, the recording on a first batch), `read_s`
    (the transcript and read_proof), `gather_s`, `fr_tape_s`, `msm_s` (the
    bases and the MSM).

    Supported: scheme "shplonk" with transcript "poseidon"; any other pair
    raises ValueError."""
    if scheme_name not in SCHEMES or transcript not in TRANSCRIPTS:
        raise ValueError(f"unsupported scheme/transcript pair {scheme_name}/{transcript}: "
                         f"the port verifies {sorted(SCHEMES)} with {sorted(TRANSCRIPTS)}")
    if not snarks:
        raise ValueError("batch_succinct_verify: empty batch")
    dev = resolve_device(device)
    B = len(snarks)

    def lookup():
        protocols = {id(s.protocol): s.protocol for s in snarks}  # tiled batches share objects
        digests = {p.content_hash() for p in protocols.values()}
        if len(digests) != 1:
            raise ValueError("a batch verifies one shared protocol")
        return succinct_plan(snarks[0].protocol, SCHEMES[scheme_name], scheme_name, transcript,
                             digest=digests.pop())

    plan = _step(timings, "plan_s", dev, lookup)
    sc, pts, instances = _step(timings, "stack_s", dev, lambda: _stack_streams(snarks, dev)
                               + (_stack_instances(snarks, dev),))
    reads = _step(timings, "read_s", dev, lambda: plan.read(
        instances, TRANSCRIPTS[transcript](sc, pts, dev), TorchLoader(B, dev)))
    inputs = _step(timings, "gather_s", dev, lambda: plan.gather(instances, reads, B))
    outs = _step(timings, "fr_tape_s", dev, lambda: plan.scalars(inputs))
    return _step(timings, "msm_s", dev, lambda: plan.accumulators(outs, pts, srs.g_dev(dev)))
