"""The transcripts' writing side against the JAX package's, on a
numpy-seeded write sequence (scalars, points, squeezes interleaved):

  * `PoseidonTranscriptPy` and `EvmTranscriptPy`: `write_scalar`,
    `write_ec_point` and `streams`, and every squeezed challenge, equal to
    the JAX package's writers; a reader over the streams squeezes the same
    challenges; the identity point is refused by both writers, as the JAX
    writers refuse it;
  * `PoseidonTranscriptWriter`, the batched writer, on the CPU: its
    challenges equal `PoseidonTranscriptPy`'s lane by lane, and its
    `streams` are the reading transcript's layout, which
    `PoseidonTranscript` reads back to the same challenges.

Tolerance: exact (python ints, canonical words)."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import py_ec as JEC
from snark_verifier_tpu.transcript.evm_transcript import EvmTranscriptPy as JEvm
from snark_verifier_tpu.transcript.poseidon_transcript import PoseidonTranscriptPy as JPos
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words
from snark_verifier_tpu_torch.ff import FRW
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.transcript import (
    EvmTranscriptPy,
    PoseidonTranscript,
    PoseidonTranscriptPy,
    PoseidonTranscriptWriter,
)

CPU = torch.device("cpu")


def _ops(seed, n=12):
    """A write sequence: ("s", int), ("p", point), ("c", None) for a squeeze."""
    rng = np.random.default_rng(seed)
    pts = JEC.rand_points(n, seed=seed + 1)
    ops = []
    for i in range(n):
        kind = ("s", "p", "c")[int(rng.integers(0, 3))]
        ops.append((kind, pts[i] if kind == "p" else
                    int.from_bytes(rng.bytes(32), "little") % (2 * FR.p)))
    return ops + [("c", None)]


def _run(t, ops):
    out = []
    for kind, v in ops:
        if kind == "s":
            t.write_scalar(v)
        elif kind == "p":
            t.write_ec_point(v)
        else:
            out.append(t.squeeze_challenge())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ours,theirs", [(PoseidonTranscriptPy, JPos), (EvmTranscriptPy, JEvm)],
                         ids=["poseidon", "evm"])
def test_host_writers_match_jax(seed, ours, theirs):
    ops = _ops(seed)
    t, jt = ours(), theirs()
    assert _run(t, ops) == _run(jt, ops)
    assert t.streams() == jt.streams()
    scalars, points = t.streams()
    reader = ours(scalars, points)
    got = []
    for kind, _ in ops:
        if kind == "s":
            reader.read_scalar()
        elif kind == "p":
            reader.read_ec_point()
        else:
            got.append(reader.squeeze_challenge())
    assert got == _run(ours(), ops)


@pytest.mark.parametrize("ours,theirs", [(PoseidonTranscriptPy, JPos), (EvmTranscriptPy, JEvm)],
                         ids=["poseidon", "evm"])
def test_writers_refuse_the_identity(ours, theirs):
    with pytest.raises(errors.TranscriptError):
        ours().write_ec_point(None)
    with pytest.raises(AssertionError):
        theirs().write_ec_point(None)


def test_batched_writer_matches_the_host_writer_and_reads_back():
    B = 3
    kinds = [k for k, _ in _ops(10)]
    rng = np.random.default_rng(5)
    pts = iter(JEC.rand_points(len(kinds) * B, seed=6))
    lanes = [[(k, next(pts) if k == "p" else int.from_bytes(rng.bytes(32), "little") % FR.p)
              for k in kinds] for _ in range(B)]
    want = [_run(PoseidonTranscriptPy(), lane) for lane in lanes]

    w = PoseidonTranscriptWriter(B, CPU)
    got = []
    for i, kind in enumerate(kinds):
        column = [lane[i][1] for lane in lanes]
        if kind == "s":
            w.write_scalar(FRW.from_int(column, CPU))
        elif kind == "p":
            w.write_ec_point(limbs_to_words(from_affine_int(column))[:, :2].contiguous())
        else:
            got.append(FRW.to_int(w.squeeze_challenge()))
    assert [[int(c[b]) for c in got] for b in range(B)] == want

    scalars, points = w.streams()
    assert scalars.shape == (B, kinds.count("s"), 8)
    assert points.shape == (B, kinds.count("p"), 2, 8)
    r = PoseidonTranscript(scalars, points, CPU)
    back = []
    for kind in kinds:
        if kind == "s":
            r.read_scalar()
        elif kind == "p":
            r.read_ec_point()
        else:
            back.append(FRW.to_int(r.squeeze_challenge()))
    assert [[int(c[b]) for c in back] for b in range(B)] == want
