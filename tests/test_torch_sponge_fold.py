"""The fused sponge squeeze and the batched / split bucket folds of the port,
on the CPU (the plain versions the kernels are held against on the card).

* `hash.absorb` / `absorb_plain` (the plain version of svt_poseidon_absorb)
  against the JAX package's `PoseidonJax` and `PoseidonPy` for buffers of 0
  to 5 elements at B = 3, against the step-by-step sponge it replaces on lazy
  [0, 2r] words, and the transcript's challenges on a fixture's whole stream.
* `pippenger.bucket_sums` (all main windows in one fold, the top window
  split into segments) on the JAX package's `_slot_indices` output, against
  a python-int oracle of every bucket; `cuda_ops.fold_buckets_split` on
  hand-made rows (a row of sentinels only, trailing segments of sentinels
  only, every segment count); whole MSMs against `py_ec.msm`.

Tolerance: exact.  Sponge states limb for limb on lazy words; points in
affine form (summation orders differ)."""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ec import from_affine_int as j_from_affine, py_ec
from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.hash import poseidon as jpos
from snark_verifier_tpu.msm import scalars_from_int as j_scalars_from_int
from snark_verifier_tpu.msm.pippenger import _slot_indices as j_slot_indices
from snark_verifier_tpu.msm.pippenger import extract_digits as j_extract_digits
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu_torch.ec import from_affine_int, from_affine_int_np, limbs_to_words
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FR, FRW
from snark_verifier_tpu_torch.ff import limbs_to_words as fe_limbs_to_words
from snark_verifier_tpu_torch.hash import PoseidonPy, PoseidonSponge, absorb, absorb_plain, permute
from snark_verifier_tpu_torch.hash.poseidon import RATE
from snark_verifier_tpu_torch.msm import cuda_ops, msm
from snark_verifier_tpu_torch.msm import pippenger as pip
from snark_verifier_tpu_torch.transcript import PoseidonTranscript

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- the sponge


@pytest.mark.parametrize("k", range(6))
def test_absorb_matches_jax_sponge_and_oracle(k):
    """Two squeezes in a row (the second from a state that is not the
    initial one): a k-element buffer, then a (5 - k)-element one."""
    B = 3
    rng = np.random.default_rng(40 + k)
    port = PoseidonSponge(B, "cpu")
    jax_sp = jpos.PoseidonJax(batch_shape=(B,))
    oracle = [PoseidonPy() for _ in range(B)]
    state = port.state
    for length in (k, 5 - k):
        lanes = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(length)]
                 for _ in range(B)]
        cols = [[lane[i] for lane in lanes] for i in range(length)]
        inputs = (torch.stack([FRW.from_int(c) for c in cols], 1) if length
                  else torch.empty((B, 0, 8), dtype=torch.int32))
        state = absorb(state, inputs.contiguous())
        assert torch.equal(state, absorb_plain(port.state, inputs))
        port.update([FRW.from_int(c) for c in cols])
        jax_sp.update([JFR.from_int(c) for c in cols])
        for o, lane in zip(oracle, lanes):
            o.update(lane)
        got = port.squeeze()
        assert torch.equal(port.state, state)
        want = np.asarray(jax_sp.squeeze())
        assert np.array_equal(words_to_limbs(got).numpy(), want.astype(np.int64))
        assert np.array_equal(words_to_limbs(state).numpy(),
                              np.asarray(jax_sp.state).astype(np.int64))
        assert list(FRW.to_int(got)) == [o.squeeze() for o in oracle]


def _stepwise(state, inputs):
    """The sponge before the fusion: one field add on the touched slots and
    one permutation per chunk."""
    batch, k = inputs.shape[:2]
    chunks = [list(range(i, min(i + RATE, k))) for i in range(0, k, RATE)]
    if k % RATE == 0:
        chunks.append([])
    for chunk in chunks:
        cols = [inputs[:, i] for i in chunk]
        if len(cols) < RATE:
            cols.append(FRW.const("ONE", state.device).expand(batch, 8))
        m = len(cols)
        mid = FRW.add(state[:, 1 : 1 + m].contiguous(), torch.stack(cols, 1))
        state = permute(torch.cat([state[:, :1], mid, state[:, 1 + m :]], 1))
    return state


@pytest.mark.parametrize("k", range(6))
def test_absorb_equals_the_stepwise_sponge_on_lazy_words(k):
    B = 3
    rng = np.random.default_rng(50 + k)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(B * (3 + k))]
    vals[:3] = [0, FR.p, 2 * FR.p]  # lazy edge representatives in the state
    if k:
        vals[3 * B : 3 * B + 2] = [2 * FR.p, FR.p]  # ... and in the buffer
    limbs = np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals])
    words = fe_limbs_to_words(torch.from_numpy(limbs.astype(np.int64)))
    state = words[: 3 * B].view(B, 3, 8).contiguous()
    inputs = words[3 * B :].view(B, k, 8).contiguous()
    assert torch.equal(absorb(state, inputs), _stepwise(state, inputs))


def test_absorb_rejects_mismatched_batches():
    state = PoseidonSponge(2, "cpu").state
    with pytest.raises(ValueError):
        absorb(state, torch.zeros((3, 1, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        absorb(state, torch.zeros((2, 8), dtype=torch.int32))


def test_transcript_challenges_over_a_whole_fixture_stream():
    """Every point and scalar of a fixture through the batched transcript
    (three lanes: the fixture and two rotations of it), a challenge after
    each group as the verifier squeezes: equal to the JAX package's python
    transcript lane by lane."""
    snark = JSnark.load(str(FIXTURES / "snark_07.json"))
    pts, scs = snark.points, snark.scalars
    lanes = [(pts[r:] + pts[:r], scs[r:] + scs[:r]) for r in (0, 1, 5)]
    sc = torch.stack([FRW.from_int(s) for _, s in lanes], 0)
    pt = torch.from_numpy(np.stack([from_affine_int_np(p)[:, :2] for p, _ in lanes], 0))
    td = PoseidonTranscript(sc.contiguous(), pt.contiguous(), "cpu")
    groups = [("p", 3), ("p", 1), ("s", 4), ("p", 5), ("s", 0), ("s", len(scs) - 4),
              ("p", len(pts) - 9)]

    def walk(t, scalar):
        out = []
        t.common_scalar(scalar(snark.instances[0][0]))
        for kind, count in groups:
            if kind == "p":
                t.read_n_ec_points(count)
            else:
                t.read_n_scalars(count)
            out.append(t.squeeze_challenge())
        return out

    got = walk(td, lambda v: FRW.from_int(v))
    for lane, (p, s) in enumerate(lanes):
        want = walk(JTranscriptPy(scalars=s, points=p), lambda v: v)
        assert [int(FRW.to_int(c[lane])) for c in got] == want


# ----------------------------------------------------------- bucket folds


def _bucket_oracle(pts, digits_row, n_buckets):
    """Bucket b = the python-int sum of the points whose digit is b (b >= 1)."""
    sums = [None] * n_buckets
    for p, d in zip(pts, digits_row):
        if d:
            sums[d] = py_ec.add(sums[d], p)
    return sums


@pytest.mark.parametrize("c", [4, 8])
def test_bucket_sums_on_jax_slot_indices_match_oracle(c):
    """All main windows in one fold and the split top window, fed the JAX
    package's index matrices (its ranking pass takes n in blocks of 512)."""
    n = 512
    rng = random.Random(60 + c)
    pts = py_ec.rand_points(n, seed=61)
    ks = [rng.randrange(FR.p) for _ in range(n)]
    digits = j_extract_digits(jnp.asarray(np.asarray(j_scalars_from_int(ks))), c)
    n_buckets, cap = 1 << c, pip.default_capacity(n, 1 << c)
    trange, tcap = pip.top_range(c), max(cap, pip.top_capacity(n, c))
    idx_all, ovf = j_slot_indices(digits[:-1], n_buckets, cap)
    top_idx, tovf = j_slot_indices(digits[-1:], trange, tcap)
    assert not bool(ovf) and not bool(tovf)
    points_ext = torch.cat([limbs_to_words(from_affine_int(pts)), pip._identity(1, "cpu")], 0)
    got = pip.bucket_sums(points_ext, torch.from_numpy(np.array(idx_all)),
                          torch.from_numpy(np.array(top_idx))[0])
    W = pip.n_windows(c)
    assert got.shape == (W, n_buckets, 3, 8)
    flat = to_affine_int(words_to_limbs(got.reshape(-1, 3, 8)))
    digits = np.asarray(digits)
    for w in range(W):
        want = _bucket_oracle(pts, digits[w].tolist(), n_buckets)
        assert flat[w * n_buckets : (w + 1) * n_buckets] == want, w


@pytest.mark.parametrize("split_rows", [3, 12, 30, 1000])
def test_fold_buckets_split_rows_of_sentinels(monkeypatch, split_rows):
    """3 rows of 10 slots: a full row, a row of sentinels only, and a row
    whose live slots end in the first segment (so its later segments hold
    sentinels only).  split_rows 3 keeps rows whole; 12 cuts them into 4
    segments of 3 with 2 slots of padding; 30 and 1000 into 10 of 1."""
    base = py_ec.rand_points(12, seed=70)
    points_ext = limbs_to_words(from_affine_int(base + [None]))
    idx = torch.full((3, 10), 12, dtype=torch.int32)
    idx[0] = torch.arange(10, dtype=torch.int32)
    idx[2, :3] = torch.tensor([11, 10, 3], dtype=torch.int32)
    monkeypatch.setattr(cuda_ops, "SPLIT_ROWS", split_rows)
    got = to_affine_int(words_to_limbs(cuda_ops.fold_buckets_split(points_ext, idx)))
    acc = None
    for p in base[:10]:
        acc = py_ec.add(acc, p)
    assert got == [acc, None, py_ec.add(py_ec.add(base[11], base[10]), base[3])]
    whole = cuda_ops.fold_buckets(points_ext, idx)
    assert got == to_affine_int(words_to_limbs(whole))


def test_fold_buckets_split_of_nothing():
    points_ext = limbs_to_words(from_affine_int([py_ec.G1_GEN, None]))
    assert cuda_ops.fold_buckets_split(points_ext, torch.empty((0, 4), dtype=torch.int32)).shape \
        == (0, 3, 8)
    out = cuda_ops.fold_buckets_split(points_ext, torch.empty((2, 0), dtype=torch.int32))
    assert to_affine_int(words_to_limbs(out)) == [None, None]


@pytest.mark.parametrize("n,c,split_rows", [(40, 8, 384), (40, 8, 49), (33, 4, 8), (7, 5, 384)])
def test_msm_through_the_batched_and_split_folds(monkeypatch, n, c, split_rows):
    """Whole MSMs on the CPU with the top window cut into several segments,
    kept whole (split_rows = its row count), and at other window widths."""
    monkeypatch.setattr(cuda_ops, "SPLIT_ROWS", split_rows)
    rng = random.Random(n + c)
    pts = py_ec.rand_points(n, seed=80 + n)
    ks = [rng.randrange(FR.p) for _ in range(n)]
    ks[0], ks[1] = FR.p - 1, 0  # the largest top digit; a scalar of no weight
    out, ovf = msm(np.asarray(j_from_affine(pts)), np.asarray(j_scalars_from_int(ks)), c=c,
                   device="cpu")
    assert not bool(ovf)
    assert to_affine_int(out) == py_ec.msm(pts, ks)
