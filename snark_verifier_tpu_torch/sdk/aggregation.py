"""Batched succinct verification and accumulator aggregation: the
counterpart of the JAX package's `sdk/aggregation.py` (`_stack_streams`
:40, `_stack_instances` :50, `batch_succinct_verify` :80, `batch_verify`
:102, `aggregate` :110, `aggregate_and_decide` :124,
`aggregate_heterogeneous` :146).

B snarks of one protocol verify as one batch on one device: their streams
are stacked on the host and uploaded once per stream, the transcript reads
the proofs (Poseidon: one `svt_poseidon_absorb` launch per challenge;
keccak, "evm": one `svt_keccak_read` launch for the whole read, over the
schedule the plan recorded), the
protocol's recorded Fr program (`verifier/plonk/plan.py`) runs as one `svt_fr_tape` launch, and the MSM as one `svt_msm_windowed`
launch.  The result is each proof's KZG accumulators (the fresh one, then
any the instances carry), to be decided by pairings.

`aggregate` folds a batch's accumulators into one with the KZG accumulation
scheme (`pcs/kzg/accumulation.py::KzgAs.fold_hierarchical`), so one pairing
decides the whole batch; `aggregate_heterogeneous` does the same for snarks
of several protocols, one batch per protocol and one shared fold.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ff import np_limbs_to_words
from ..ff.spec import FR, int_to_limbs
from ..loader.base import TorchLoader
from ..pcs.kzg.accumulation import KzgAs
from ..pcs.kzg.decider import decide
from ..pcs.kzg.multiopen import Bdfg21, Gwc19
from ..transcript.poseidon_transcript import PoseidonTranscript
from ..verifier.plonk.plan import succinct_plan
from .snark import Snark

SCHEMES = {"shplonk": Bdfg21, "gwc": Gwc19}
TRANSCRIPTS = ("poseidon", "evm")


def _stack_streams(snarks: Sequence[Snark], device):
    """-> scalars (B, n, 8), points (B, m, 2, 8) words: one upload each."""
    pairs = [s.host_streams() for s in snarks]
    sc = torch.from_numpy(np.stack([p[0] for p in pairs], 0)).to(device)
    pts = torch.from_numpy(np.stack([p[1] for p in pairs], 0)).to(device)
    return sc, pts


def _instance_block(snarks: Sequence[Snark], device, mont: bool = True):
    """-> (B, n_inst, 8) Fr words of every lane's instances, column by
    column, in Montgomery form (`mont`) or as canonical plain words (the
    scalars of an instance commitment): one host block, one upload."""
    p, R = FR.p, (1 << 256) if mont else 1
    num_instance = snarks[0].protocol.num_instance
    flat = np.zeros((len(snarks), sum(num_instance), 16), np.uint32)
    for b, s in enumerate(snarks):
        vals = [v for col in s.instances for v in col]
        for k, v in enumerate(vals):
            flat[b, k] = int_to_limbs((v % p) * R % p)
    return torch.from_numpy(np_limbs_to_words(flat)).to(device)


def _instance_columns(block, num_instance):
    """(B, n_inst, 8) -> a list (per instance column) of lists of (B, 8) views."""
    out, k = [], 0
    for ncol in num_instance:
        out.append([block[:, k + i] for i in range(ncol)])
        k += ncol
    return out


def _stack_instances(snarks: Sequence[Snark], device):
    """-> a list (per instance column) of lists of (B, 8) Fr words, from one
    host block and one upload."""
    return _instance_columns(_instance_block(snarks, device), snarks[0].protocol.num_instance)


def _synchronize(where):
    """Wait for `where`: a device, or a mesh (`parallel.mesh.Mesh`, each of
    its cards)."""
    if not isinstance(where, torch.device):
        where.synchronize()
    elif where.type == "cuda":
        torch.cuda.synchronize(where)


def _step(timings, key: str, where, fn):
    """fn(); with `timings`, its host seconds added under `key` (a sharded
    path sums its shards), between two synchronizes of `where`, a device or
    a mesh."""
    if timings is None:
        return fn()
    _synchronize(where)
    t = time.perf_counter()
    r = fn()
    _synchronize(where)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t
    return r


def batch_succinct_verify(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                          transcript: str = "poseidon", device=None, timings: dict = None):
    """One batched succinct verification of B same-protocol snarks on
    `device` (None: the CUDA card).  Returns the list of (lhs, rhs)
    accumulators, each (B, 3, 8) projective G1 words: the fresh one, then
    the old ones the protocol's `accumulator_indices` name.  The protocol's Fr
    program is recorded on its first batch in this process and replayed
    (`verifier/plonk/plan.py`).

    `timings`, when given, gets each step's host seconds, each step between
    two synchronizes: `stack_s` (stack and upload), `plan_s` (the protocol
    check and the plan lookup, the recording on a first batch), `read_s`
    (the instance commitment of an instance-committing-key protocol, the
    transcript and read_proof), `gather_s`, `fr_tape_s`, `msm_s` (the
    bases and the MSM).

    Supported: the schemes "shplonk" and "gwc", each with the transcripts
    "poseidon" and "evm" (keccak); anything else raises ValueError."""
    if scheme_name not in SCHEMES or transcript not in TRANSCRIPTS:
        raise ValueError(f"unsupported scheme/transcript pair {scheme_name}/{transcript}: "
                         f"the port verifies the schemes {sorted(SCHEMES)} with the "
                         f"transcripts {sorted(TRANSCRIPTS)}")
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
                             digest=digests.pop(), device=dev)

    plan = _step(timings, "plan_s", dev, lookup)
    ick = plan.protocol.instance_committing_key is not None
    sc, pts, inst, inst_plain = _step(
        timings, "stack_s", dev, lambda: _stack_streams(snarks, dev)
        + (_instance_block(snarks, dev), _instance_block(snarks, dev, mont=False) if ick else None))
    instances = _instance_columns(inst, plan.protocol.num_instance)

    def read():
        lanes = plan.commit(inst_plain)
        if transcript == "evm":
            return plan.read_keccak(inst, instances, sc, pts, TorchLoader(B, dev), lanes), lanes
        return plan.read(instances, PoseidonTranscript(sc, pts, dev, lanes=lanes),
                         TorchLoader(B, dev)), lanes

    reads, lanes = _step(timings, "read_s", dev, read)
    inputs = _step(timings, "gather_s", dev, lambda: plan.gather(instances, reads, B))
    outs = _step(timings, "fr_tape_s", dev, lambda: plan.scalars(inputs))
    return _step(timings, "msm_s", dev,
                 lambda: plan.accumulators(outs, pts, srs.g_dev(dev), inputs, lanes))


def batch_verify(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                 transcript: str = "poseidon", device=None, timings: dict = None):
    """Verify B same-protocol snarks -> (B,) bool, one accept bit a proof:
    the JAX package's `sdk.aggregation.batch_verify`, the name its users and
    examples call.  It is `parallel.batch_verify.batch_verify` (the succinct
    phase, then the pairing decide, on `device`, None meaning the CUDA
    card), imported here at call time: that module imports this one."""
    from ..parallel.batch_verify import batch_verify as verify

    return verify(snarks, srs, scheme_name, transcript, device, timings)


def stack_pairs(accs) -> torch.Tensor:
    """[(lhs, rhs)], each (B, 3, 8) -> (len(accs)·B, 2, 3, 8), accumulator-major
    (the JAX package's absorb order)."""
    return torch.cat([torch.stack([lhs, rhs], 1) for lhs, rhs in accs], 0)


def aggregate(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk", device=None):
    """Fold every accumulator of a same-protocol batch into one -> (lhs, rhs),
    each (3, 8): the batched succinct phase, the accumulator-major stack and
    `KzgAs.fold_hierarchical`."""
    accs = batch_succinct_verify(snarks, srs, scheme_name, device=device)
    return KzgAs.fold_hierarchical(stack_pairs(accs))


def aggregate_and_decide(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                         device=None):
    """`aggregate`, then one pairing check -> a 0-dim bool tensor."""
    lhs, rhs = aggregate(snarks, srs, scheme_name, device)
    return decide(srs, lhs, rhs)


def aggregate_heterogeneous(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                            device=None):
    """Snarks of several protocols -> one folded (lhs, rhs), each (3, 8).
    One `batch_succinct_verify` per protocol (grouped by `content_hash()`),
    then one fold of every accumulator in the original snark order (each
    snark's accumulators together), so the fold's challenge does not depend
    on the grouping."""
    if not snarks:
        raise ValueError("aggregate_heterogeneous: empty batch")
    dev = resolve_device(device)
    groups: Dict[str, List[int]] = {}
    for i, s in enumerate(snarks):
        groups.setdefault(s.protocol.content_hash(), []).append(i)
    per_snark: List[List[Tuple]] = [[] for _ in snarks]
    for idxs in groups.values():
        accs = batch_succinct_verify([snarks[i] for i in idxs], srs, scheme_name, device=dev)
        for lhs, rhs in accs:
            for j, i in enumerate(idxs):
                per_snark[i].append(torch.stack([lhs[j], rhs[j]], 0))
    pairs = torch.stack([acc for lst in per_snark for acc in lst], 0)
    return KzgAs.fold_hierarchical(pairs)


def aggregate_heterogeneous_and_decide(snarks: Sequence[Snark], srs,
                                       scheme_name: str = "shplonk", device=None):
    """`aggregate_heterogeneous`, then one pairing check -> a 0-dim bool."""
    lhs, rhs = aggregate_heterogeneous(snarks, srs, scheme_name, device)
    return decide(srs, lhs, rhs)
