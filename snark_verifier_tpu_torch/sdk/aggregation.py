"""Batched succinct verification and accumulator aggregation: the
counterpart of the JAX package's `sdk/aggregation.py` (`_stack_streams`
:40, `_stack_instances` :50, `batch_succinct_verify` :80, `batch_verify`
:102, `aggregate` :110, `aggregate_and_decide` :124,
`aggregate_heterogeneous` :146).

B snarks of one protocol verify as one batch on one device: their streams
and instances are written into one host block (pinned for a card) and sent
as one non-blocking upload (`_pack_inputs`), the transcript reads
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

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._launch import COUNTERS
from ..device import resolve_device
from ..ff.spec import FR
from ..loader.base import TorchLoader
from ..pcs.kzg.accumulation import KzgAs
from ..pcs.kzg.decider import decide
from ..pcs.kzg.multiopen import Bdfg21, Gwc19
from ..transcript.poseidon_transcript import PoseidonTranscript
from ..utils.timing import _step
from ..verifier.plonk.plan import succinct_plan
from .snark import Snark

SCHEMES = {"shplonk": Bdfg21, "gwc": Gwc19}
TRANSCRIPTS = ("poseidon", "evm")


def _host_block(n: int, device) -> torch.Tensor:
    """A fresh host block of n int32 words for one upload to `device`:
    pinned where `device` is a CUDA card, so the copy is queued and the host
    goes on (torch's caching host allocator serves the block and does not
    hand it out again before the copy that reads it has run), plain memory
    elsewhere, where the upload is the block itself."""
    return torch.empty(n, dtype=torch.int32, pin_memory=torch.device(device).type == "cuda")


def _carve(block, shapes) -> list:
    """Contiguous views of the 1-D `block` (a tensor, or its numpy view on
    the host), one a shape, back to back.  Every shape ends in whole 8-word
    elements, so each view starts on a 32-byte boundary of the block."""
    views, k = [], 0
    for shape in shapes:
        n = math.prod(shape)
        views.append(block[k:k + n].reshape(shape))
        k += n
    return views


def _write_words(view: np.ndarray, values):
    """Fr values in [0, p) -> their 32 little-endian bytes each, joined and
    written over the host view's int32 words in one copy."""
    view.reshape(-1)[:] = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values), "<i4")


def _stack_streams(snarks: Sequence[Snark], device, out=None):
    """-> scalars (B, n, 8), points (B, m, 2, 8) words of every lane's
    `host_streams`: one host block, one upload.  With `out`, numpy views
    (scalars, points) of a batch's packed host block, the words are written
    there and nothing is uploaded."""
    pairs = [s.host_streams() for s in snarks]
    block = None
    if out is None:
        shapes = [(len(snarks),) + a.shape for a in pairs[0]]
        block = _host_block(sum(map(math.prod, shapes)), device)
        out = _carve(block.numpy(), shapes)
    for i, view in enumerate(out):
        parts = [pair[i] for pair in pairs]  # zip(*pairs) would hold B iterators: a GC pass
        if set(map(len, parts)) != {view.shape[1]}:  # the copy checks the total
            raise ValueError("the batch's proof streams differ in shape")
        view.reshape(-1)[:] = np.frombuffer(b"".join(parts), np.int32)
    if block is None:
        return out
    return tuple(_carve(block.to(device, non_blocking=True), shapes))


def _instance_block(snarks: Sequence[Snark], device, mont: bool = True, out=None):
    """-> (B, n_inst, 8) Fr words of every lane's instances, column by
    column, in Montgomery form (`mont`) or as canonical plain words (the
    scalars of an instance commitment): one host block, one upload.  With
    `out`, numpy views (Montgomery, plain) of a batch's packed host block,
    either None, each view given is written from one walk over the lanes
    and nothing is uploaded."""
    shape = (len(snarks), sum(snarks[0].protocol.num_instance), 8)
    if out is None:
        block = _host_block(math.prod(shape), device).view(shape)
        host = block.numpy()
        _instance_block(snarks, device, out=(host, None) if mont else (None, host))
        return block.to(device, non_blocking=True)
    p = FR.p
    vals = [v for s in snarks for col in s.instances for v in col]
    if len(vals) != shape[0] * shape[1]:
        raise ValueError(f"{len(vals)} instance values for {shape[0]} lanes of {shape[1]}")
    mont_out, plain_out = out
    if mont_out is not None:
        _write_words(mont_out, [(v << 256) % p for v in vals])  # v·R mod p, R = 2^256
    if plain_out is not None:
        _write_words(plain_out, [v % p for v in vals])
    return out


def _pack_inputs(snarks: Sequence[Snark], device, plain: bool):
    """A batch's inputs -> [scalars (B, n, 8), points (B, m, 2, 8),
    instances (B, n_inst, 8)] words on `device`, and the instances as plain
    words (B, n_inst, 8) after them where `plain`: written into one host
    block (`_stack_streams`, `_instance_block`) and sent as one
    non-blocking upload (the span "svt::verify.upload", one count of
    `COUNTERS["packed_uploads"]`), each a contiguous view of the one
    device block."""
    B, s0 = len(snarks), snarks[0]
    n_inst = sum(s0.protocol.num_instance)
    shapes = [(B, len(s0.scalars), 8), (B, len(s0.points), 2, 8), (B, n_inst, 8)]
    if plain:
        shapes.append((B, n_inst, 8))
    block = _host_block(sum(map(math.prod, shapes)), device)
    sc, pts, *inst = _carve(block.numpy(), shapes)
    _step("verify.streams", lambda: _stack_streams(snarks, device, out=(sc, pts)))
    _step("verify.instances",
          lambda: _instance_block(snarks, device, out=(inst[0], inst[1] if plain else None)))

    def upload():
        COUNTERS["packed_uploads"] += 1
        return _carve(block.to(device, non_blocking=True), shapes)

    return _step("verify.upload", upload)


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


def batch_succinct_verify(snarks: Sequence[Snark], srs, scheme_name: str = "shplonk",
                          transcript: str = "poseidon", device=None, timings: dict = None):
    """One batched succinct verification of B same-protocol snarks on
    `device` (None: the CUDA card).  Returns the list of (lhs, rhs)
    accumulators, each (B, 3, 8) projective G1 words: the fresh one, then
    the old ones the protocol's `accumulator_indices` name.  The protocol's Fr
    program is recorded on its first batch in this process and replayed
    (`verifier/plonk/plan.py`).

    Each step is a span (`utils.timing._step`, "svt::verify.<step>").
    `timings`, when given, gets each step's host seconds, each step between
    two synchronizes: `stack_s` (stack and upload), `plan_s` (the protocol
    check and the plan lookup, the recording on a first batch), `read_s`
    (the instance commitment of an instance-committing-key protocol, the
    transcript and read_proof), `gather_s`, `fr_tape_s`, `msm_s` (the
    bases and the MSM), and `acc_decode_s` (the old accumulators' limb
    decode) where the protocol names `accumulator_indices`.

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

    plan = _step("verify.plan", lookup, timings, "plan_s", dev)
    ick = plan.protocol.instance_committing_key is not None

    sc, pts, inst, *plain = _step("verify.stack", lambda: _pack_inputs(snarks, dev, ick), timings,
                                  "stack_s", dev)
    inst_plain = plain[0] if plain else None
    instances = _instance_columns(inst, plan.protocol.num_instance)

    def read():
        lanes = plan.commit(inst_plain)
        if transcript == "evm":
            return plan.read_keccak(inst, instances, sc, pts, TorchLoader(B, dev), lanes), lanes
        return plan.read(instances, PoseidonTranscript(sc, pts, dev, lanes=lanes),
                         TorchLoader(B, dev)), lanes

    reads, lanes = _step("verify.read", read, timings, "read_s", dev)
    inputs = _step("verify.gather", lambda: plan.gather(instances, reads, B), timings, "gather_s",
                   dev)
    outs = _step("verify.fr_tape", lambda: plan.scalars(inputs), timings, "fr_tape_s", dev)
    accs = _step("verify.msm", lambda: plan.accumulators(outs, pts, srs.g_dev(dev), lanes),
                 timings, "msm_s", dev)
    if plan.has_old_accumulators:
        accs += _step("verify.acc_decode", lambda: plan.old_accumulators(inputs), timings,
                      "acc_decode_s", dev)
    return accs


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
