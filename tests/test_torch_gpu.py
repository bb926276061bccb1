"""The port's CUDA kernels on the card, against their plain PyTorch twins and
the python-int oracle.  Marked `gpu`: each test skips (inside the test) where
no CUDA card is present.  This file imports neither jax nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance: exact; add and double canonically (and limb for limb); the fold,
the verify MSM (`msm_windowed`), the bucket reduction and the MSM in affine
form (their summation orders differ from the twins'); the pairing kernels
canonically (they skip products by 1)."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
from snark_verifier_tpu_torch.ec import (
    from_affine_int,
    limbs_to_words,
    py_ec,
    to_affine_int,
    words_to_limbs,
)
from snark_verifier_tpu_torch.ff import FQ_FIELD, FR, digits4
from snark_verifier_tpu_torch.ff import FQ, FQW
from snark_verifier_tpu_torch.msm import cuda_ops, msm, msm_checked, scalars_from_int
from snark_verifier_tpu_torch.pairing import py_pairing as pp
from snark_verifier_tpu_torch.pairing.pairing import (
    final_exponentiation,
    final_exponentiation_plain,
    fq12_op,
    fq12_op_plain,
    is_one,
    miller_loop,
    miller_loop_plain,
    prepare_pairs,
)
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params
from snark_verifier_tpu_torch.tower import fq12_from_int, fq12_to_int, tower_from_int
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_words(b, seed, device):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 16, size=(b, 3, 16), dtype=np.int64)
    raw[..., 15] &= 0x1FFF
    return limbs_to_words(torch.as_tensor(raw, device=device))


def _special_pairs(device):
    P = py_ec.rand_points(1, seed=3)[0]
    a = from_affine_int([None, P, P, P, None], device=device)
    b = from_affine_int([P, None, P, py_ec.neg(P), None], device=device)
    return limbs_to_words(a), limbs_to_words(b), [P, P, py_ec.double(P), None, None]


def test_add_kernel_matches_twin(cuda):
    a = _rand_words(4099, 1, cuda)
    b = _rand_words(4099, 2, cuda)
    sa, sb, want = _special_pairs(cuda)
    a, b = torch.cat([sa, a]), torch.cat([sb, b])
    cuda_ops.reset_launches()
    got = cuda_ops.add(a, b)
    assert cuda_ops.LAUNCHES["add"] == 1
    twin = cuda_ops.add_plain(a, b)
    torch.cuda.synchronize()
    # canonical words: the twin's lazy words after canon
    assert torch.equal(words_to_limbs(got), FQ_FIELD.canon(words_to_limbs(got)))
    assert torch.equal(FQ_FIELD.canon(words_to_limbs(got)), FQ_FIELD.canon(words_to_limbs(twin)))
    assert to_affine_int(words_to_limbs(got[:5])) == want


def test_double_kernel_matches_twin(cuda):
    a = _rand_words(3000, 3, cuda)
    sa, _, _ = _special_pairs(cuda)
    a = torch.cat([sa, a])
    got = cuda_ops.double(a)
    assert torch.equal(words_to_limbs(got), FQ_FIELD.canon(words_to_limbs(got)))
    assert torch.equal(FQ_FIELD.canon(words_to_limbs(got)),
                       FQ_FIELD.canon(words_to_limbs(cuda_ops.double_plain(a))))
    P = py_ec.rand_points(1, seed=3)[0]
    assert to_affine_int(words_to_limbs(got[1:2])) == [py_ec.double(P)]


# svt_g1_add / svt_g1_double walk tiles of 128 points with persistent blocks:
# the batch sizes at a tile's edges, the sharded fold's 2 and ragged
# multi-tile batches (up to several tiles a block on a card of 132 SMs).
@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000, 132 * 3 * 128 + 77, 100_003])
def test_add_and_double_kernels_at_ragged_sizes(cuda, n):
    a = _rand_words(n, 10 + n % 97, cuda)
    b = _rand_words(n, 20 + n % 89, cuda)
    sa, sb, want = _special_pairs(cuda)
    k = min(n, 5)
    a[:k], b[:k] = sa[:k], sb[:k]
    cuda_ops.reset_launches()
    got_add, got_dbl = cuda_ops.add(a, b), cuda_ops.double(a)
    assert cuda_ops.LAUNCHES["add"] == 1 and cuda_ops.LAUNCHES["double"] == 1
    for got, twin in ((got_add, cuda_ops.add_plain(a, b)), (got_dbl, cuda_ops.double_plain(a))):
        g = words_to_limbs(got)
        assert torch.equal(g, FQ_FIELD.canon(g))
        assert torch.equal(g, FQ_FIELD.canon(words_to_limbs(twin)))
    assert to_affine_int(words_to_limbs(got_add[:k])) == want[:k]


def test_add_kernel_at_the_sharded_fold_shape(cuda):
    """(2, 3, 8): the two partial sums a fold level of the sharded MSM adds
    at D = 4, canonical words equal to the twin's after canon."""
    pts = [py_ec.scalar_mul(py_ec.G1_GEN, k) for k in (3, 5, 7, 11)]
    parts = limbs_to_words(from_affine_int(pts, device=cuda)).view(4, 3, 8)
    got = cuda_ops.add(parts[:2].contiguous(), parts[2:].contiguous())
    twin = cuda_ops.add_plain(parts[:2].contiguous(), parts[2:].contiguous())
    assert torch.equal(words_to_limbs(got), FQ_FIELD.canon(words_to_limbs(twin)))
    assert to_affine_int(words_to_limbs(got)) == [py_ec.scalar_mul(py_ec.G1_GEN, 10),
                                                  py_ec.scalar_mul(py_ec.G1_GEN, 16)]


def test_fold_kernel_matches_twin_and_oracle(cuda):
    base = py_ec.rand_points(6, seed=5)
    pts_ext = limbs_to_words(from_affine_int(base + [None], device=cuda))
    rng = np.random.default_rng(6)
    idx = torch.as_tensor(rng.integers(0, 7, size=(9, 700)), dtype=torch.int32, device=cuda)
    idx[0] = 6  # empty bucket
    got = cuda_ops.fold_buckets(pts_ext, idx)
    twin = cuda_ops.fold_buckets_plain(pts_ext, idx)
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(twin))
    assert ga[0] is None
    counts = [np.bincount(r, minlength=7) for r in idx.cpu().numpy()]
    want = [py_ec.msm(base, [int(c) for c in row[:6]]) for row in counts]
    assert ga == want


@pytest.mark.parametrize("rows,team", [(1, 128), (49, 128), (256, 128), (500, 64), (7936, 32)])
def test_fold_teams_match_twin(cuda, rows, team):
    """From one row to all main windows of an MSM: each row count gets the
    team its launch fills the card with (128, 64 or 32 threads a row on a
    card of 132 SMs); caps that leave lanes without a slot, a row of
    sentinels only."""
    base = py_ec.rand_points(5, seed=21)
    pts_ext = limbs_to_words(from_affine_int(base + [None], device=cuda))
    rng = np.random.default_rng(rows)
    cap = 37 if rows > 256 else 333
    idx = torch.as_tensor(rng.integers(0, 6, size=(rows, cap)), dtype=torch.int32, device=cuda)
    idx[rows // 2] = 5  # a row of sentinels only
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert cuda_ops._fold_team(rows, cuda) == team
    cuda_ops.reset_launches()
    got = cuda_ops.fold_buckets(pts_ext, idx)
    assert cuda_ops.LAUNCHES["fold_buckets"] == 1
    twin = cuda_ops.fold_buckets_plain(pts_ext, idx)
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(twin))
    assert ga[rows // 2] is None


def test_fold_split_on_card_matches_twin(cuda):
    base = py_ec.rand_points(5, seed=22)
    pts_ext = limbs_to_words(from_affine_int(base + [None], device=cuda))
    rng = np.random.default_rng(23)
    idx = torch.as_tensor(rng.integers(0, 6, size=(49, 1001)), dtype=torch.int32, device=cuda)
    idx[3] = 5
    idx[4, 100:] = 5  # its later segments hold sentinels only
    cuda_ops.reset_launches()
    got = cuda_ops.fold_buckets_split(pts_ext, idx)
    assert cuda_ops.LAUNCHES["fold_buckets"] == 1 and cuda_ops.LAUNCHES["fold_segments"] == 1
    twin = cuda_ops.fold_buckets_plain(pts_ext, idx)
    assert to_affine_int(words_to_limbs(got)) == to_affine_int(words_to_limbs(twin))


def test_fold_split_at_the_top_window_shape(cuda):
    """fold_buckets_split at the 2^20 MSM's top-window shape (49, 25,846):
    one fold_buckets and one fold_segments launch, equal to the plain
    version and to the python-int bucket sums."""
    base = py_ec.rand_points(7, seed=24)
    pts_ext = limbs_to_words(from_affine_int(base + [None], device=cuda))
    rng = np.random.default_rng(25)
    idx = torch.as_tensor(rng.integers(0, 8, size=(49, 25846)), dtype=torch.int32, device=cuda)
    idx[5] = 7
    cuda_ops.reset_launches()
    got = cuda_ops.fold_buckets_split(pts_ext, idx)
    assert cuda_ops.LAUNCHES["fold_buckets"] == 1 and cuda_ops.LAUNCHES["fold_segments"] == 1
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(cuda_ops.fold_buckets_plain(pts_ext, idx)))
    counts = [np.bincount(r, minlength=8) for r in idx.cpu().numpy()]
    assert ga == [py_ec.msm(base, [int(c) for c in row[:7]]) for row in counts]
    assert ga[5] is None


def test_msm_on_card_matches_oracle(cuda):
    pts = py_ec.rand_points(300, seed=7)
    rng = np.random.default_rng(8)
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(300)]
    cuda_ops.reset_launches()
    out, ovf = msm(from_affine_int(pts), scalars_from_int(ks))
    assert out.device.type == "cuda" and not bool(ovf)
    assert cuda_ops.LAUNCHES["fold_buckets"] > 0 and cuda_ops.LAUNCHES["bucket_reduce"] == 1
    assert cuda_ops.LAUNCHES["add"] == 0 and cuda_ops.LAUNCHES["double"] == 0
    assert to_affine_int(out) == py_ec.msm(pts, ks)
    cpu, _ = msm(from_affine_int(pts), scalars_from_int(ks), device="cpu")
    assert to_affine_int(cpu) == to_affine_int(out)


def test_msm_checked_retry_on_card(cuda):
    pts = py_ec.rand_points(64, seed=9)
    ks = [5] * 64
    _, ovf = msm(from_affine_int(pts), scalars_from_int(ks), capacity=8)
    assert bool(ovf)
    out = msm_checked(from_affine_int(pts), scalars_from_int(ks), capacity=8)
    assert to_affine_int(out) == py_ec.msm(pts, ks)


def _scalar_words(ints, device):
    raw = np.frombuffer(b"".join(int(k).to_bytes(32, "little") for k in ints), dtype="<i4")
    return torch.from_numpy(raw.reshape(-1, 8).copy()).to(device)


@pytest.mark.parametrize("B,n", [(1, 1), (1, 2), (33, 26), (3, 32), (2, 33), (2, 64)])
def test_msm_windowed_kernel_matches_plain_and_oracle(cuda, B, n):
    """Teams past the last proof (B odd), lanes past n, a second group of
    bases (n > 32), identity and repeated bases, scalars 0, 1, r - 1 and
    2^256 - 1 (all digits 15)."""
    rng = np.random.default_rng(100 + n)
    aff = []
    for b in range(B):
        pts = py_ec.rand_points(n, seed=200 + b)
        if n >= 2:
            pts[1] = None
        if n >= 4:
            pts[3] = pts[2]
        aff.append(pts)
    ks = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)] for _ in range(B)]
    for i, k in enumerate((0, 1, FR.p - 1, (1 << 256) - 1)):
        if i < n:
            ks[0][i] = k
    pts = limbs_to_words(from_affine_int([p for row in aff for p in row], device=cuda))
    pts = pts.view(B, n, 3, 8)
    sc = _scalar_words([k for row in ks for k in row], cuda).view(B, n, 8)
    cuda_ops.reset_launches()
    got = cuda_ops.msm_windowed(pts, sc)
    assert cuda_ops.LAUNCHES["msm_windowed"] == 1 and cuda_ops.LAUNCHES["add"] == 0
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(cuda_ops.msm_windowed_plain(pts, digits4(sc))))
    assert ga == [py_ec.msm(a, [k % FR.p for k in row]) for a, row in zip(aff, ks)]


@pytest.mark.parametrize("team", cuda_ops.MSMW_TEAMS)
@pytest.mark.parametrize("B,n,per_block", [(3, 26, 2), (2, 33, 1), (5, 1, 4), (3, 0, 2)])
def test_msm_windowed_every_team_matches_oracle(cuda, team, B, n, per_block):
    """Every team size at a forced layout: a ragged last block (B odd), a
    proof with more bases than a block of teams 6 holds with two proofs
    (n = 33), one base, no bases (the identity)."""
    rng = np.random.default_rng(500 + n)
    aff = [py_ec.rand_points(n, seed=510 + b) for b in range(B)]
    ks = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)] for _ in range(B)]
    if n:
        aff[0][0] = None
        ks[-1][0] = FR.p - 1
    pts = limbs_to_words(from_affine_int([p for row in aff for p in row], device=cuda))
    pts = pts.reshape(B, n, 3, 8).contiguous()
    sc = _scalar_words([k for row in ks for k in row], cuda).reshape(B, n, 8).contiguous()
    cuda_ops.reset_launches()
    got = cuda_ops._msm_windowed_at(pts, sc, team, per_block)
    assert cuda_ops.LAUNCHES["msm_windowed"] == 1
    ga = to_affine_int(words_to_limbs(got))
    assert ga == [py_ec.msm(a, row) if n else None for a, row in zip(aff, ks)]
    if n:
        assert ga == to_affine_int(words_to_limbs(cuda_ops.msm_windowed_plain(pts, digits4(sc))))


def test_msm_windowed_kernel_at_the_verify_shape(cuda):
    """(1024, 26), the verify batch's MSM: 26 bases tiled over the batch
    with each proof's own scalars, against the plain version on the card."""
    B, n = 1024, 26
    base = limbs_to_words(from_affine_int(py_ec.rand_points(n, seed=300), device=cuda))
    pts = base.expand(B, n, 3, 8).contiguous()
    rng = np.random.default_rng(301)
    sc = _scalar_words([int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(B * n)],
                       cuda).view(B, n, 8)
    got = cuda_ops.msm_windowed(pts, sc)
    want = cuda_ops.msm_windowed_plain(pts, digits4(sc))
    assert to_affine_int(words_to_limbs(got)) == to_affine_int(words_to_limbs(want))


@pytest.mark.parametrize("kind", ["random", "empty", "equal"])
def test_bucket_reduce_kernel_matches_plain_and_oracle(cuda, kind):
    """The MSM's (32, 256) bucket sums with its top window padded past
    bucket 48: random multiples of G, all identities, all equal."""
    from snark_verifier_tpu_torch.msm import pippenger as pip

    k = np.random.default_rng(400).integers(0, 8, size=(32, 256))
    if kind != "random":
        k[:] = 0 if kind == "empty" else 3
    k[-1, pip.top_range(8):] = 0
    pool = limbs_to_words(from_affine_int(
        [py_ec.scalar_mul(py_ec.G1_GEN, j) for j in range(8)], device=cuda))
    buckets = pool[torch.as_tensor(k, device=cuda)].contiguous()
    cuda_ops.reset_launches()
    got = pip.bucket_reduce(buckets, 8)
    assert cuda_ops.LAUNCHES["bucket_reduce"] == 1 and cuda_ops.LAUNCHES["double"] == 0
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(pip.bucket_reduce_plain(buckets, 8)))
    total = sum((b * int(k[w, b])) << (8 * w) for w in range(32) for b in range(256))
    assert ga == [py_ec.scalar_mul(py_ec.G1_GEN, total % FR.p)]
    with pytest.raises(ValueError):
        pip.bucket_reduce(buckets[:, :16].contiguous(), 4)  # only c = 8 on the card


def _dense(nb, w, seed, device):
    base = py_ec.rand_points(4, seed=seed)
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 5, size=(nb, w))
    table = base + [None]
    aff = [[table[k] for k in row] for row in pick]
    flat = from_affine_int([p for row in aff for p in row], device=device)
    return limbs_to_words(flat).view(nb, w, 3, 8), aff


def _affine_rows(words):
    nb, g = words.shape[:2]
    flat = to_affine_int(words_to_limbs(words.reshape(nb * g, 3, 8)))
    return [flat[i * g : (i + 1) * g] for i in range(nb)]


@pytest.mark.parametrize("kind", ["level", "halving", "grid"])
def test_fold_segments_kernel_matches_twin(cuda, kind):
    mat, _ = _dense(3, 48, 11, cuda)
    fn = {"level": lambda m: cuda_ops.fold_level(m, 8),
          "halving": lambda m: cuda_ops.fold_halving(m, 4),
          "grid": lambda m: cuda_ops.fold_grid(m, 16, 2)}[kind]
    cuda_ops.reset_launches()
    got = fn(mat)
    assert cuda_ops.LAUNCHES["fold_segments"] == 1
    assert _affine_rows(got) == _affine_rows(fn(mat.cpu()))


@pytest.mark.parametrize("team", cuda_ops.TEAMS)
@pytest.mark.parametrize("kind,w", [("level", 48), ("level", 45), ("halving", 48),
                                    ("halving", 41), ("grid", 48), ("grid", 37)])
def test_fold_segments_kernel_every_team(cuda, kind, w, team):
    """The kernel at each team size against its plain version, on widths
    that tile the grouping and on widths read as padded with identities."""
    mat, aff = _dense(3, w, 13 + w, cuda)
    grp = {"level": cuda_ops.level_grouping(w, 8), "halving": cuda_ops.halving_grouping(w, 4),
           "grid": cuda_ops.grid_grouping(w, 16, 2)}[kind]
    cuda_ops.reset_launches()
    got = cuda_ops.fold_segments(mat, *grp, team=team)
    assert cuda_ops.LAUNCHES["fold_segments"] == 1
    rows = _affine_rows(got)
    assert rows == _affine_rows(cuda_ops.fold_segments_plain(mat, *grp))
    G, CW, S, count, _ = grp
    for b, row in enumerate(aff):
        for j, pt in enumerate(rows[b]):
            acc = None
            for k in range(count):
                m = (j // G) * CW + j % G + k * S
                if m < w:
                    acc = py_ec.add(acc, row[m])
            assert pt == acc


@pytest.mark.parametrize("driver", ["chunked", "halving", "grid"])
def test_dense_drivers_on_card_match_oracle(cuda, driver):
    mat, aff = _dense(4, 300, 12, cuda)
    fn, levels = {
        "chunked": (cuda_ops.fold_buckets_chunked, cuda_ops.chunked_levels(300)),
        "halving": (cuda_ops.fold_buckets_halving, cuda_ops.halving_levels(300)),
        "grid": (lambda m: cuda_ops.fold_buckets_grid_dense(m, wb=64, layers=3),
                 cuda_ops.grid_levels(300, 64, 3))}[driver]
    cuda_ops.reset_launches()
    got = to_affine_int(words_to_limbs(fn(mat)))
    assert cuda_ops.LAUNCHES["fold_segments"] == len(levels)  # no padding copy, no other launch
    want = []
    for row in aff:
        acc = None
        for p in row:
            acc = py_ec.add(acc, p)
        want.append(acc)
    assert got == want


def _canon_words(w):
    return FQ_FIELD.canon(words_to_limbs(w))


def test_chain_kernels_match_twins(cuda):
    """The add chain writes canonical words (csrc/g1.cuh::g1_add_sum), equal
    to the plain version's after `canon`; the integer multiply and square
    chains (route 0) equal theirs word for word, one launch a call."""
    a, b = _rand_words(300, 13, cuda), _rand_words(300, 14, cuda)
    got = cuda_ops.g1_add_chain(a, b, 5)
    assert torch.equal(words_to_limbs(got), _canon_words(got))
    assert torch.equal(_canon_words(got), _canon_words(cuda_ops.g1_add_chain_plain(a, b, 5)))
    x, y = a[:, 0].contiguous(), b[:, 1].contiguous()
    assert torch.equal(cuda_ops.fq_mul_chain(x, y, 7, route=0),
                       cuda_ops.fq_mul_chain_plain(x, y, 7))
    cuda_ops.reset_launches()
    assert torch.equal(cuda_ops.fq_sqr_chain(x, 7, route=0), cuda_ops.fq_sqr_chain_plain(x, 7))
    assert cuda_ops.LAUNCHES["fq_mul_chain"] == 1


@pytest.mark.parametrize("n", [1, 127, 129, 132 * 6 * 128 + 77])
def test_add_chain_canonical_at_ragged_batches(cuda, n):
    """Persistent blocks over a ragged last tile, and more tiles than one
    wave: canonical words equal to the plain version after `canon`; CH = 0
    writes a itself, canonical."""
    a, b = _rand_words(n, 20 + n % 7, cuda), _rand_words(n, 30 + n % 5, cuda)
    for ch in (0, 3):
        got = cuda_ops.g1_add_chain(a, b, ch)
        assert torch.equal(words_to_limbs(got), _canon_words(got))
        assert torch.equal(_canon_words(got), _canon_words(cuda_ops.g1_add_chain_plain(a, b, ch)))


@pytest.mark.parametrize("ch", [0, 1, 7, 16])
def test_fp64_chain_route_matches_twins_after_canon(cuda, ch):
    """Route 1 (csrc/fq_f64.cuh): canonical words equal to the plain
    multiply and square chains after `canon`, with 0, p and 2p among the
    lazy inputs; one launch a call."""
    x = _rand_words(4099, 40 + ch, cuda)[:, 0].contiguous()
    y = _rand_words(4099, 50 + ch, cuda)[:, 2].contiguous()
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in (0, FQ.p, 2 * FQ.p)),
                        dtype="<u2").astype(np.int64).reshape(3, 16)
    x[:3] = limbs_to_words(torch.as_tensor(raw, device=cuda))
    cuda_ops.reset_launches()
    for got, want in ((cuda_ops.fq_mul_chain(x, y, ch, route=1),
                       cuda_ops.fq_mul_chain_plain(x, y, ch)),
                      (cuda_ops.fq_sqr_chain(x, ch, route=1), cuda_ops.fq_sqr_chain_plain(x, ch))):
        assert torch.equal(words_to_limbs(got), _canon_words(got))
        assert torch.equal(_canon_words(got), _canon_words(want))
    assert cuda_ops.LAUNCHES["fq_mul_chain"] == 2


def test_chain_unknown_route_raises(cuda):
    x = _rand_words(8, 60, cuda)[:, 0].contiguous()
    for call in (lambda: cuda_ops.fq_mul_chain(x, x, 2, route=2),
                 lambda: cuda_ops.fq_sqr_chain(x, 2, route=-1)):
        with pytest.raises(ValueError):
            call()


def _word_vals(t):
    return [int.from_bytes(r.tobytes(), "little") for r in t.cpu().numpy().astype("<u4")]


@pytest.mark.parametrize("fname", ["fq", "fr"])
@pytest.mark.parametrize("n", [1024, 2048, 64, 4])
def test_field_inv_kernel_matches_canon_plain(cuda, fname, n):
    """svt_field_inv (binary GCD) at the tree's shapes and the verify row's:
    the canonical word of the plain Fermat inverse, and A^-1 R for x = A R
    in python ints; 0, 1, p - 1 and lazy words in [p, 2p] among the inputs."""
    from snark_verifier_tpu_torch.ff import FQW, FRW

    F = FQW if fname == "fq" else FRW
    p = F.spec.p
    rng = np.random.default_rng(n + (fname == "fr"))
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p]
    vals += [p + int.from_bytes(rng.bytes(32), "little") % p for _ in range(n // 4)]
    vals += [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(n)]
    vals = vals[:n]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
    a = torch.from_numpy(raw.reshape(n, 8).copy()).to(cuda)
    reset_launches()
    got = F.inv(a)
    assert LAUNCHES["field_inv"] == 1
    assert torch.equal(got, F.plain("canon", F.plain("inv", a)))
    R = 1 << 256
    assert _word_vals(got) == [pow(x, p - 2, p) * R * R % p for x in vals]


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_field_kernels_match_twins(cuda, fname):
    from snark_verifier_tpu_torch.ff import FQW, FRW

    F = FQW if fname == "fq" else FRW
    p = F.spec.p
    rng = np.random.default_rng(15)
    vals = [0, 1, p - 1, p, 2 * p] + [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1)
                                       for _ in range(995)]
    raw = np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals])
    a = limbs_to_words(torch.as_tensor(raw, device=cuda))
    b = a.flip(0).contiguous()
    c = a[7]  # one element broadcast over the batch
    for op in ("mul", "add", "sub"):
        for x, y in ((a, b), (a, c), (c, b)):
            got = getattr(F, op)(x, y)
            assert torch.equal(got, getattr(F, op)(x.cpu(), y.cpu()).to(cuda)), op
    for op in ("neg", "canon"):
        assert torch.equal(getattr(F, op)(a), getattr(F, op)(a.cpu()).to(cuda)), op
    # the card's inverse (binary GCD) is canonical, the plain one (Fermat) lazy
    src = a[:64]
    assert torch.equal(F.inv(src), F.canon(F.inv(src.cpu())).to(cuda)), "inv"
    got = F.batch_inv(a[:40].view(5, 8, 8))
    want = F.batch_inv(a[:40].view(5, 8, 8).cpu())
    assert torch.equal(F.canon(got).cpu(), F.canon(want))


def test_poseidon_kernel_matches_twin_and_kat(cuda):
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.hash import permute, permute_plain

    rng = np.random.default_rng(16)
    st = FRW.from_int([int.from_bytes(rng.bytes(32), "little") for _ in range(3 * 257)])
    st = st.view(257, 3, 8).to(cuda)
    assert torch.equal(permute(st), permute_plain(st.cpu()).to(cuda))
    kat = permute(FRW.from_int([0, 1, 2]).view(1, 3, 8).to(cuda))
    assert list(FRW.to_int(kat[0])) == [
        7853200120776062878684798364095072458815029376092732009249414926327459813530,
        7142104613055408817911962100316808866448378443474503659992478482890339429929,
        6549537674122432311777789598043107870002137484850126429160507761192163713804,
    ]


@pytest.mark.parametrize("k", range(6))
def test_poseidon_absorb_kernel_matches_plain_sponge(cuda, k):
    from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.hash import absorb, absorb_plain

    rng = np.random.default_rng(17 + k)
    B = 131  # not a multiple of a warp's states: the tail block shadows
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(B * (3 + k))]
    vals[:3] = [0, FR.p, 2 * FR.p]
    raw = np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals])
    words = limbs_to_words(torch.as_tensor(raw, device=cuda))
    st = words[: 3 * B].view(B, 3, 8).contiguous()
    buf = words[3 * B :].view(B, k, 8).contiguous()
    reset_launches()
    got = absorb(st, buf)
    assert LAUNCHES["poseidon_absorb"] == 1 and LAUNCHES["poseidon_permute"] == 0
    assert torch.equal(got, absorb_plain(st.cpu(), buf.cpu()).to(cuda))


def test_batch_succinct_verify_on_card_matches_oracle(cuda):
    from pathlib import Path

    from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import load_params
    from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    srs = load_params(str(d / "srs.bin"))
    snarks = [Snark.load(str(d / f"snark_{i:02d}.json")) for i in range(3)]
    reset_launches()
    (lhs, rhs), = batch_succinct_verify(snarks, srs)
    assert LAUNCHES["poseidon_absorb"] > 0
    assert LAUNCHES["fr_tape"] == 1 and LAUNCHES["msm_windowed"] == 1
    assert LAUNCHES["points_to_fr"] == 1  # the stream's Fq -> Fr map
    assert sum(v for k, v in LAUNCHES.items() if k.startswith("field_")) == 0
    assert LAUNCHES["add"] == 0 and LAUNCHES["double"] == 0
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [succinct_verify_native(s, srs)[0] for s in snarks]


@functools.lru_cache(maxsize=None)
def _fr_tape_plans():
    """The recorded SHPLONK and GWC19 plans (vanilla k=10) and the IPA k =
    11 plan's tape."""
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as ipa_fx
    from snark_verifier_tpu_torch.pcs.ipa import ipa_plan
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
    from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    first = lambda prefix: Snark.load(str(d / f"{prefix}_00.json")).protocol
    return {"shplonk": succinct_plan(first("snark"), Bdfg21, "shplonk", "poseidon"),
            "gwc19": succinct_plan(first("gwcsnark"), Gwc19, "gwc", "poseidon"),
            "ipa_k11": ipa_plan("ipa", ipa_fx.ipa_keys()[0].svk, device="cpu").tape}


def _fr_tape_inputs(device, B, name="shplonk"):
    """A tape and its (n_in, B, 8) input block: for SHPLONK and GWC19 the 16
    fixtures tiled to B lanes, as the verify path gathers them; for IPA
    random lazy words (numpy seed 19, 0, r and 2r first)."""
    from snark_verifier_tpu_torch.loader.base import TorchLoader
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.transcript import PoseidonTranscript

    plan = _fr_tape_plans()[name]
    if name == "ipa_k11":
        rng = np.random.default_rng(19)
        n = len(plan.inputs) * B
        vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(n)]
        vals[:3] = [0, FR.p, 2 * FR.p][:n]
        words = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals]
        ins = torch.tensor(np.array(words, np.uint32).view(np.int32).reshape(-1, B, 8),
                           device=device)
        return plan, ins
    prefix = "snark" if name == "shplonk" else "gwcsnark"
    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    base = [Snark.load(str(d / f"{prefix}_{i:02d}.json")) for i in range(16)]
    snarks = [base[i % 16] for i in range(B)]
    sc, pts = agg._stack_streams(snarks, device)
    inst = agg._stack_instances(snarks, device)
    reads = plan.read(inst, PoseidonTranscript(sc, pts, device), TorchLoader(B, device))
    return plan.tape, plan.gather(inst, reads, B).contiguous()


@pytest.mark.parametrize("B", [1024, 33, 1])
def test_fr_tape_kernel_matches_run_plain(cuda, B):
    """The kernel at the wrapper's team size and at every other, on the
    SHPLONK, GWC19 and IPA tapes: one launch a call, word for word."""
    from snark_verifier_tpu_torch.ff import fr_tape

    for name in ("shplonk", "gwc19", "ipa_k11"):
        tape, inputs = _fr_tape_inputs(cuda, B, name)
        want = fr_tape.run_plain(tape, inputs)
        for team in (None,) + fr_tape.TEAMS:
            reset_launches()
            got = fr_tape.run(tape, inputs, team=team)
            assert LAUNCHES["fr_tape"] == 1
            torch.cuda.synchronize()
            assert got.shape == (len(tape.outputs), B, 8)
            assert torch.equal(got, want), (name, team)
        with pytest.raises(ValueError):  # the kernel's wrapper takes no CPU tensor
            fr_tape.run(tape, inputs.cpu())


def test_wrappers_reject_on_card(cuda):
    a = _rand_words(8, 4, cuda)
    with pytest.raises(ValueError):
        cuda_ops.add(a, a.cpu())
    with pytest.raises(ValueError):  # a point buffer off 16-byte alignment
        flat = torch.empty(8 * 24 + 1, dtype=torch.int32, device=cuda)
        cuda_ops.double(flat[1:].view(8, 3, 8))


# ------------------------------------------------------------------ pairing


def _rand_f12s(n, seed):
    rng = np.random.default_rng(seed)
    v = [int.from_bytes(rng.bytes(32), "little") % FQ.p for _ in range(12 * n)]
    return [tuple(tuple((v[12 * b + 6 * i + 2 * j], v[12 * b + 6 * i + 2 * j + 1])
                        for j in range(3)) for i in range(2)) for b in range(n)]


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): an element of the cyclotomic subgroup."""
    m = pp.f12_mul(pp.f12_conj(f), pp.f12_inv(f))
    return pp.f12_mul(pp.f12_frob(m, 2), m)


F12_ZERO = tuple(tuple((0, 0) for _ in range(3)) for _ in range(2))

_OP_ORACLE = {
    "mul": lambda a, b, l: pp.f12_mul(a, b),
    "square": lambda a, b, l: pp.f12_sq(a),
    "mul_by_034": lambda a, b, l: pp.f12_mul_by_034(a, *l),
    "frob1": lambda a, b, l: pp.f12_frob(a, 1),
    "frob2": lambda a, b, l: pp.f12_frob(a, 2),
    "frob3": lambda a, b, l: pp.f12_frob(a, 3),
    "conj": lambda a, b, l: pp.f12_conj(a),
    "inv": lambda a, b, l: pp.f12_inv(a),
    "cyclo_square": lambda a, b, l: pp.f12_sq(a),
}


@pytest.mark.parametrize("op", list(_OP_ORACLE))
def test_fq12_op_kernel_matches_plain_and_oracle(cuda, op):
    """67 elements (17 blocks of 4 teams, the last ragged); cyclo_square on
    cyclotomic-subgroup elements and 0."""
    n = 67
    A, Bv = _rand_f12s(n, 1), _rand_f12s(n, 2)
    if op == "cyclo_square":
        A = [_cyclotomic(x) for x in A[:-1]] + [F12_ZERO]
    lines = [f[0] for f in _rand_f12s(n, 3)]
    a = fq12_from_int(A, cuda)
    b = fq12_from_int(Bv, cuda) if op == "mul" else (
        tower_from_int(lines, 6, cuda) if op == "mul_by_034" else None)
    reset_launches()
    got = fq12_op(op, a, b)
    assert LAUNCHES["fq12_op"] == 1
    plain = fq12_op_plain(op, a, b)
    canon = lambda w: FQ_FIELD.canon(words_to_limbs(w))
    assert torch.equal(canon(got), canon(plain))
    ints = fq12_to_int(got)
    check = list(range(5)) + ([n - 1] if op == "cyclo_square" else [])
    assert all(ints[i] == _OP_ORACLE[op](A[i], Bv[i], lines[i]) for i in check)


@pytest.mark.parametrize("B", [1, 33, 1024])
def test_miller_loop_kernel_matches_plain_and_oracle(cuda, B):
    """Lane 0 affine against the oracle; the other lanes projective random
    coordinates (lane 1 with Z = 0) against the plain version."""
    g1, g2 = py_ec.G1_GEN, pp.G2_GEN
    pairs = [(py_ec.scalar_mul(g1, 777), g2), (g1, pp.g2_scalar_mul(g2, 31337))]
    want = pp.miller_loop([(p, pp.prepare_g2(q)) for p, q in pairs])
    xs, ys, dbl, addc, has_add, finals = prepare_pairs(pairs)
    up = lambda t: torch.from_numpy(t).to(cuda)
    lines = (up(dbl), up(addc), has_add, up(finals))
    X = _rand_words(B, 7, cuda)[:, :2].contiguous()
    Y = _rand_words(B, 8, cuda)[:, :2].contiguous()
    Z = _rand_words(B, 9, cuda)[:, :2].contiguous()
    X[0], Y[0], Z[0] = up(xs), up(ys), FQW.from_int([1, 1], cuda)  # affine: Z = 1
    if B > 1:
        Z[1] = 0
    reset_launches()
    got = miller_loop(X, Y, Z, *lines)
    assert LAUNCHES["miller_loop"] == 1
    assert fq12_to_int(got[0]) == want
    plain = miller_loop_plain(X, Y, Z, *lines)
    assert torch.equal(FQ_FIELD.canon(words_to_limbs(got)), FQ_FIELD.canon(words_to_limbs(plain)))


@pytest.mark.parametrize("B", [1, 33, 1024])
def test_final_exp_kernel_matches_plain_and_oracle(cuda, B):
    """Random lanes, and (B > 1) an f = 0 lane (decides false: 0 maps to 0)
    and an f = 1 lane (maps to 1)."""
    fs = _rand_f12s(B, 9)
    if B > 1:
        fs[1] = F12_ZERO
        fs[-1] = pp.F12_ONE
    f = fq12_from_int(fs, cuda)
    reset_launches()
    got = final_exponentiation(f)
    assert LAUNCHES["final_exp"] == 1
    assert torch.equal(got, final_exponentiation_plain(f))  # both canonical
    ints = fq12_to_int(got)
    assert ints[0] == pp.final_exponentiation(fs[0])
    ones = is_one(got).tolist()
    assert ones[0] is False
    if B > 1:
        assert not bool(got[1].any()) and ones[1] is False
        assert ones[-1] is True and ints[-1] == pp.F12_ONE


def test_batch_verify_on_card_matches_oracle(cuda):
    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    srs = load_params(str(d / "srs.bin"))
    snarks = [Snark.load(str(d / f"snark_{i:02d}.json")) for i in range(3)]
    s0 = snarks[0]
    snarks[0] = Snark(s0.protocol, [list(c) for c in s0.instances], s0.scalars, s0.points)
    snarks[0].instances[0][0] = (snarks[0].instances[0][0] + 1) % FR.p
    reset_launches()
    oks = batch_verify(snarks, srs)
    assert LAUNCHES["miller_loop"] == 1 and LAUNCHES["final_exp"] == 1
    assert LAUNCHES["msm_windowed"] == 1 and LAUNCHES["points_to_fr"] == 1
    assert not _field_launches()
    want = [pp.pairing_check([(lhs, srs.g2), (rhs, pp.g2_neg(srs.s_g2))])
            for (lhs, rhs), in (succinct_verify_native(s, srs) for s in snarks)]
    assert want == [False, True, True]
    assert oks.tolist() == want


def test_pairing_wrappers_reject_on_card(cuda):
    f = torch.zeros((4, 2, 3, 2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        final_exponentiation(f.to(torch.int64))
    with pytest.raises(ValueError):
        final_exponentiation(f[:, 0])
    with pytest.raises(ValueError):
        fq12_op("mul", f, f.cpu())
    with pytest.raises(ValueError):
        fq12_op("mul_by_034", f, f)
    with pytest.raises(ValueError):
        fq12_op("pow", f)
    xs = torch.zeros((4, 2, 8), dtype=torch.int32, device=cuda)
    lines = torch.zeros((65, 2, 3, 2, 8), dtype=torch.int32, device=cuda)
    fin = torch.zeros((2, 2, 3, 2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 64 steps of lines
        miller_loop(xs, xs, xs, lines[:64], lines, np.zeros(65, bool), fin)
    with pytest.raises(ValueError):  # lines for three pairs
        three = torch.zeros((65, 3, 3, 2, 8), dtype=torch.int32, device=cuda)
        miller_loop(xs, xs, xs, three, lines, np.zeros(65, bool), fin)
    with pytest.raises(ValueError):
        miller_loop(xs, xs, xs, lines, lines, np.zeros(64, bool), fin)
    with pytest.raises(ValueError):  # points for three pairs
        xs3 = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
        miller_loop(xs3, xs3, xs3, lines, lines, np.zeros(65, bool), fin)
    with pytest.raises(ValueError):  # zs of another batch
        miller_loop(xs, xs, xs[:2], lines, lines, np.zeros(65, bool), fin)


# ------------------------------------------------- accumulation (GWC, the tree)


def _fixtures(prefix, n):
    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    return load_params(str(d / "srs.bin")), [Snark.load(str(d / f"{prefix}_{i:02d}.json"))
                                             for i in range(n)]


def _rand_fr_words(b, seed, device):
    rng = np.random.default_rng(seed)
    from snark_verifier_tpu_torch.ff import FRW

    return FRW.from_int([int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(b)],
                        device=device)


@pytest.mark.parametrize("B,n", [(1, 1), (32, 32), (1000, 33), (1, 32), (1024, 33), (3, 2),
                                 (3, 31), (3, 64), (3, 65), (5, 200)])
def test_fr_powers_kernel_matches_plain(cuda, B, n):
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import powers, powers_plain

    r = _rand_fr_words(B, B + n, cuda)
    reset_launches()
    got = powers(r, n)
    assert LAUNCHES["fr_powers"] == 1
    want = powers_plain(r, n)
    torch.cuda.synchronize()
    assert got.shape == (B, n, 8) and torch.equal(got, want)
    with pytest.raises(ValueError):
        powers(r, 0)
    with pytest.raises(ValueError):
        powers(torch.stack([r, r], -1)[..., 0], n)


def _rand_pairs_words(G, N, seed, device):
    pts = py_ec.rand_points(2 * G * N, seed=seed)
    return limbs_to_words(from_affine_int(pts, device=device)).view(G, N, 2, 3, 8)


def test_stacked_absorb_and_fold_level_match_plain(cuda):
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs, fold_transcript

    pairs = _rand_pairs_words(4, 32, 5, cuda)
    xy = cuda_ops.affine_xy(pairs.reshape(4, 64, 3, 8))
    t_k, t_p = fold_transcript(4, cuda), fold_transcript(4, "cpu")
    t_k.absorb_ec_points(xy)
    t_p.absorb_ec_points(xy.cpu())
    reset_launches()
    r = t_k.squeeze_challenge()
    assert LAUNCHES["poseidon_absorb"] == 1
    assert torch.equal(r.cpu(), t_p.squeeze_challenge())
    t_j = fold_transcript(4, cuda)
    reset_launches()
    t_j.absorb_projective_points(pairs.reshape(4, 64, 3, 8))
    assert LAUNCHES["points_to_fr"] == 1 and not _field_launches()
    assert torch.equal(t_j.squeeze_challenge(), r)
    reset_launches()
    lhs, rhs = KzgAs._fold_once(pairs)
    assert {k: LAUNCHES[k] for k in ("poseidon_absorb", "fr_powers", "msm_windowed",
                                     "points_to_fr")} == {
        "poseidon_absorb": 1, "fr_powers": 1, "msm_windowed": 1, "points_to_fr": 1}
    assert not _field_launches()
    pl, pr = KzgAs._fold_once(pairs.cpu())
    for a, b in ((lhs, pl), (rhs, pr)):
        assert to_affine_int(words_to_limbs(a)) == to_affine_int(words_to_limbs(b))


def test_gwc_batch_on_card_matches_oracle(cuda):
    srs, snarks = _fixtures("gwcsnark", 3)
    reset_launches()
    (lhs, rhs), = batch_succinct_verify(snarks, srs, "gwc")
    assert LAUNCHES["fr_tape"] == 1 and LAUNCHES["msm_windowed"] == 2
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [succinct_verify_native(s, srs, "gwc")[0] for s in snarks]
    assert batch_verify(snarks, srs, "gwc").tolist() == [True] * 3


def test_tree_root_on_card_matches_oracle(cuda):
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_root
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy

    srs, base = _fixtures("snark", 4)
    snarks = [base[i % 4] for i in range(64)]  # 64 accumulators: 2 groups of 32, then the root
    reset_launches()
    lhs, rhs, ok = tree_aggregate_root(snarks, srs)
    assert bool(ok)
    assert LAUNCHES["fr_powers"] == 3 and LAUNCHES["miller_loop"] == 1
    assert LAUNCHES["points_to_fr"] == 4 and not _field_launches()
    accs = [succinct_verify_native(s, srs)[0] for s in base]

    def fold(pairs):
        return KzgAs.create_proof(None, pairs, PoseidonTranscriptPy())

    group = fold([accs[i % 4] for i in range(32)])
    want = fold([fold([group, group])])
    assert (to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))) == want
    s = base[0]
    tam = Snark(s.protocol, [list(c) for c in s.instances], s.scalars, s.points)
    tam.instances[0][0] = (tam.instances[0][0] + 1) % FR.p
    assert not bool(tree_aggregate_root([tam] + snarks[1:], srs)[2])


def test_four_leaf_tree_launches(cuda):
    """A 4-leaf tree folds once, then the root: one points_to_fr launch in
    the succinct phase and one a fold level, no single-op field launch."""
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_root
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy

    srs, base = _fixtures("snark", 4)
    reset_launches()
    lhs, rhs, ok = tree_aggregate_root(base, srs)
    assert bool(ok)
    assert {k: v for k, v in LAUNCHES.items() if v and k in (
        "points_to_fr", "fr_powers", "fr_tape", "miller_loop", "final_exp")} == {
        "points_to_fr": 3, "fr_powers": 2, "fr_tape": 1, "miller_loop": 1, "final_exp": 1}
    assert not _field_launches()
    accs = [succinct_verify_native(s, srs)[0] for s in base]
    want = KzgAs.create_proof(None, [KzgAs.create_proof(None, accs, PoseidonTranscriptPy())],
                              PoseidonTranscriptPy())
    assert (to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))) == want


def _fq_words(vals, device):
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
    return torch.from_numpy(raw.reshape(-1, 8).copy()).to(device)


@pytest.mark.parametrize("shape", [(1024, 16, 2), (3, 1)])
def test_points_to_fr_affine_matches_plain(cuda, shape):
    from snark_verifier_tpu_torch.ff import FQ, points_to_fr, points_to_fr_plain

    rng = np.random.default_rng(sum(shape))
    n = int(np.prod(shape))
    vals = [0, 1, FR.p - 1, FR.p, FQ.p - 1, FQ.p, 2 * FQ.p]
    vals = (vals + [int.from_bytes(rng.bytes(32), "little") % (2 * FQ.p + 1)
                    for _ in range(n)])[:n]
    x = _fq_words(vals, cuda).view(*shape, 8)
    reset_launches()
    got = points_to_fr(x)
    assert LAUNCHES["points_to_fr"] == 1 and not _field_launches()
    assert got.shape == x.shape
    assert torch.equal(got.cpu(), points_to_fr_plain(x.cpu()))
    R = 1 << 256
    assert [w % FR.p for w in _word_vals(got.view(-1, 8))] == [  # lazy Fr words
        v * pow(R, -1, FQ.p) % FQ.p % FR.p * R % FR.p for v in vals]


@pytest.mark.parametrize("n", [2048, 64, 4, 37])
def test_points_to_fr_projective_matches_plain(cuda, n):
    """The fold levels' shapes: valid points with Z = 1 and random Z, and
    identity lanes with Z = 0, p and 2p under random X and Y."""
    from snark_verifier_tpu_torch.ff import FQ, points_to_fr, points_to_fr_plain

    rng = np.random.default_rng(n)
    q, R = FQ.p, 1 << 256
    aff = py_ec.rand_points(n, seed=n)
    rows, want = [], []
    for k, (x, y) in enumerate(aff):
        lam = 1 if k % 4 == 0 else int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1
        if k % 16 in (1, 2, 3):  # the identity, Z = 0, p, 2p
            z = (0, q, 2 * q)[k % 16 - 1]
            rows += [int.from_bytes(rng.bytes(32), "little") % (2 * q + 1) for _ in range(2)]
            rows.append(z)
            want += [0, 0]
            continue
        rows += [x * lam % q * R % q, y * lam % q * R % q, lam * R % q]
        want += [x % FR.p * R % FR.p, y % FR.p * R % FR.p]
    pts = _fq_words(rows, cuda).view(n, 3, 8)
    reset_launches()
    got = points_to_fr(pts, projective=True)
    assert LAUNCHES["points_to_fr"] == 1 and not _field_launches()
    assert got.shape == (n, 2, 8)
    assert torch.equal(got.cpu(), points_to_fr_plain(pts.cpu(), projective=True))
    assert [w % FR.p for w in _word_vals(got.view(-1, 8))] == want  # lazy Fr words


def test_points_to_fr_rejects_on_card(cuda):
    from snark_verifier_tpu_torch.ff import points_to_fr

    x = torch.zeros((4, 3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        points_to_fr(x[:, :2], projective=True)
    with pytest.raises(TypeError):
        points_to_fr(x.long())
    assert torch.equal(points_to_fr(x[:, :, :8].transpose(0, 1)), points_to_fr(
        x.transpose(0, 1).contiguous()))  # a strided operand is made contiguous


def _old_acc(name):
    """A committed snark whose instances carry an old accumulator as 12
    limbs (tests/test_torch_old_accumulators.py writes them); "plain": the
    valid one with its protocol naming no accumulator."""
    d = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "fixtures"
    with open(d / f"old_acc_{'valid' if name == 'plain' else name}.json") as f:
        raw = json.load(f)
    if name == "plain":
        raw["protocol"]["accumulator_indices"] = []
    return Snark.from_json(raw)


def _field_launches():
    return {k: v for k, v in LAUNCHES.items() if k.startswith("field_") and v}


def test_old_accumulators_on_card_match_oracle(cuda):
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.pcs.kzg.accumulator import (
        accumulator_from_limbs,
        accumulator_from_limbs_int,
    )
    from snark_verifier_tpu_torch.sdk.srs import toy_srs

    srs = toy_srs(32)
    valid, bogus, plain = (_old_acc(n) for n in ("valid", "bogus", "plain"))
    old = accumulator_from_limbs_int(valid.instances[0])
    reset_launches()
    lhs, rhs = accumulator_from_limbs(FRW.from_int(valid.instances[0], cuda)[:, None].unbind(0))
    decode = _field_launches()
    assert decode == {"field_mul": 2, "field_canon": 1}
    assert list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs)))) == [old]
    want = succinct_verify_native(valid, srs)
    assert want[1] == old
    B = 4
    reset_launches()
    fresh_only = batch_succinct_verify([plain] * B, srs)
    base = _field_launches()
    assert base == {} and LAUNCHES["points_to_fr"] == 1
    reset_launches()
    accs = batch_succinct_verify([valid] * B, srs)
    assert LAUNCHES["fr_tape"] == 1 and LAUNCHES["msm_windowed"] == 1
    assert _field_launches() == {k: base.get(k, 0) + decode.get(k, 0) for k in base.keys() | decode}
    got = [list(zip(to_affine_int(words_to_limbs(l)), to_affine_int(words_to_limbs(r))))
           for l, r in accs]
    assert [list(lane) for lane in zip(*got)] == [want] * B
    assert got[0] == [want[0]] * B == list(zip(*(to_affine_int(words_to_limbs(w))
                                                 for w in fresh_only[0])))
    assert batch_verify([valid] * B, srs).tolist() == [True] * B
    assert batch_verify([bogus] * B, srs).tolist() == [False] * B


# ------------------------------------------------------- keccak (the EVM family)


def _keccak_words(n, W, seed, device):
    """(n, W, 8) words and (W,) tags: all three tags, raw words of hash size."""
    from snark_verifier_tpu_torch.hash.keccak_device import TAG_FR, TAG_RAW

    rng = np.random.default_rng(seed)
    tags = [int(t) for t in rng.integers(0, 3, size=W)]
    cols = []
    for t in tags:
        p = FR.p if t == TAG_FR else FQ.p
        vals = [int.from_bytes(rng.bytes(32), "little") if t == TAG_RAW
                else int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(n)]
        raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
        cols.append(torch.from_numpy(raw.reshape(n, 8).copy()))
    return torch.stack(cols, 1).contiguous().to(device), tags


@pytest.mark.parametrize("W", [1, 3, 4, 5, 8, 9, 17, 26, 30])
def test_keccak_squeeze_kernel_matches_plain(cuda, W):
    from snark_verifier_tpu_torch.hash.keccak import keccak256
    from snark_verifier_tpu_torch.hash.keccak_device import squeeze, squeeze_plain

    words, tags = _keccak_words(1000, W, W, cuda)
    reset_launches()
    h, c = squeeze(words, tags)
    assert LAUNCHES["keccak_squeeze"] == 1
    hp, cp = squeeze_plain(words, tags)
    torch.cuda.synchronize()
    assert torch.equal(h, hp) and torch.equal(c, cp)
    # lane 0 against the oracle: tagged words hashed as their canonical values
    data = b""
    for t, row in zip(tags, words[0].cpu()):
        v = sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(row))
        if t:
            p = FR.p if t == 1 else FQ.p
            v = v * pow(1 << 256, -1, p) % p
        data += v.to_bytes(32, "big")
    got = sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(h[0].cpu()))
    assert got == int.from_bytes(keccak256(data + (b"\x01" if W == 1 else b"")), "big")
    # every challenge is its hash mod r, hashes past 2r (~60% of them) included
    for hr, cr in zip(h.cpu().numpy().astype("<u4"), c.cpu().numpy().astype("<u4")):
        hv, cv = int.from_bytes(hr.tobytes(), "little"), int.from_bytes(cr.tobytes(), "little")
        assert cv % FR.p == hv * (1 << 256) % FR.p and cv < 2 * FR.p
    with pytest.raises(ValueError):
        squeeze(words, tags[:-1] + [3])


def test_evm_batch_on_card_matches_oracle(cuda):
    srs, snarks = _fixtures("evmsnark", 3)
    reset_launches()
    (lhs, rhs), = batch_succinct_verify(snarks, srs, "shplonk", "evm")
    assert LAUNCHES["keccak_read"] == 1 and LAUNCHES["keccak_squeeze"] == 0
    assert LAUNCHES["poseidon_absorb"] == 0
    assert LAUNCHES["fr_tape"] == 1 and LAUNCHES["msm_windowed"] == 1
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [succinct_verify_native(s, srs, "shplonk", "evm")[0] for s in snarks]
    bad = Snark(snarks[0].protocol, [list(c) for c in snarks[0].instances], snarks[0].scalars,
                snarks[0].points)
    bad.instances[0][0] = (bad.instances[0][0] + 1) % FR.p
    assert batch_verify([bad] + snarks[1:], srs, "shplonk", "evm").tolist() == [False, True, True]
    assert batch_verify(snarks, srs, "shplonk", "poseidon").tolist() == [False] * 3


def test_keccak_read_kernel_matches_read_plain(cuda):
    """svt_keccak_read over the evmsnark protocol's recorded read at 16
    lanes, one launch: equal to read_plain word for word, every challenge
    the python-int transcript's."""
    from snark_verifier_tpu_torch.hash import keccak_device as kd
    from snark_verifier_tpu_torch.loader.base import NATIVE
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.transcript import EvmTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan
    from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkSuccinctVerifier

    _, snarks = _fixtures("evmsnark", 16)
    plan = succinct_plan(snarks[0].protocol, Bdfg21, "shplonk", "evm")
    inst = agg._instance_block(snarks, cuda)
    sc, pts = agg._stack_streams(snarks, cuda)
    reset_launches()
    h, c = kd.read(plan.keccak, inst, sc, pts)
    assert LAUNCHES["keccak_read"] == 1 and LAUNCHES["keccak_squeeze"] == 0
    hp, cp = kd.read_plain(plan.keccak, inst, sc, pts)
    torch.cuda.synchronize()
    assert torch.equal(h, hp) and torch.equal(c, cp)
    for b, s in enumerate(snarks):
        t = EvmTranscriptPy(s.scalars, s.points)
        PlonkSuccinctVerifier.read_proof(s.protocol, [list(v) for v in s.instances], t, Bdfg21,
                                         NATIVE)
        assert [v % FR.p for v in _word_vals(c[:, b])] == [
            x * (1 << 256) % FR.p for x in t.challenges]


def test_keccak_read_kernel_long_buffers(cuda):
    """A schedule of every source with buffers past one chunk of 32 words
    (the ring of sponge lanes wraps) at B = 50, against read_plain."""
    from snark_verifier_tpu_torch.hash import keccak_device as kd

    B = 50
    rng = np.random.default_rng(3)

    def words(*shape):  # values in [0, 2r]: lazy in either field, whatever a row's tag
        n = int(np.prod(shape))
        vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(n)]
        raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
        return torch.from_numpy(raw.reshape(*shape, 8).copy()).to(cuda)

    inst, sc, pts = words(B, 5), words(B, 80), words(B, 10, 2)
    srcs = [(kd.SRC_INSTANCE, 5), (kd.SRC_SCALAR, 80), (kd.SRC_POINT_X, 10),
            (kd.SRC_POINT_Y, 10), (kd.SRC_CONST, 2)]
    squeezes = []
    for q, W in enumerate([40, 1, 70, 33, 3]):
        sq = [(kd.SRC_HASH, q - 1, kd.TAG_RAW)] if q else []
        while len(sq) < W:
            src, n = srcs[int(rng.integers(0, len(srcs)))]
            sq.append((src, int(rng.integers(0, n)), int(rng.integers(0, 3))))
        squeezes.append(sq)
    sched = kd.ReadSchedule(squeezes, [FR.p - 1, 12345])
    reset_launches()
    h, c = kd.read(sched, inst, sc, pts)
    assert LAUNCHES["keccak_read"] == 1
    hp, cp = kd.read_plain(sched, inst, sc, pts)
    torch.cuda.synchronize()
    assert torch.equal(h, hp) and torch.equal(c, cp)


# ------------------------------------------------ the IPA family, ick protocols


@pytest.mark.parametrize("k", [0, 1, 5, 9, 11, 12, 20])
def test_ipa_h_coeffs_kernel_matches_plain(cuda, k):
    """svt_ipa_h_coeffs against h_coeffs_plain, word for word, one launch;
    with a scalar factor, and against python ints where k is small."""
    from snark_verifier_tpu_torch.ff import FRW, limbs_to_int
    from snark_verifier_tpu_torch.pcs.ipa import h_coeffs_int

    rng = np.random.default_rng(500 + k)
    xi = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(k)]
    s = int.from_bytes(rng.bytes(32), "little") % FR.p
    xw = FRW.from_int(xi, cuda) if k else torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    sw = FRW.from_int(s, cuda)
    reset_launches()
    got = cuda_ops.h_coeffs(xw)
    got_s = cuda_ops.h_coeffs(xw, sw)
    assert LAUNCHES["ipa_h_coeffs"] == 2
    assert torch.equal(got, cuda_ops.h_coeffs_plain(xw))
    assert torch.equal(got_s, cuda_ops.h_coeffs_plain(xw, sw))
    if k <= 11:
        assert [limbs_to_int(r) for r in got_s.cpu().numpy()] == h_coeffs_int(xi, s)


def test_ipa_h_coeffs_kernel_at_k23_samples(cuda):
    """k = 23: the tile index spans three 5-bit chunks (bits 10-22), more
    than the main path's k = 20 uses; sampled coefficients (every chunk of
    the tile index zero, nonzero and all ones among them) against python
    ints."""
    from snark_verifier_tpu_torch.ff import FRW, limbs_to_int

    k = 23
    rng = np.random.default_rng(523)
    xi = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(k)]
    s = int.from_bytes(rng.bytes(32), "little") % FR.p
    got = cuda_ops.h_coeffs(FRW.from_int(xi, cuda), FRW.from_int(s, cuda))
    sample = [0, 1, 1023, 1024, (1 << 15) + 5, (1 << 20) + 7, (1 << 22) + 3, (1 << k) - 1]
    sample += [int(j) for j in rng.integers(0, 1 << k, size=40)]
    rows = got[torch.tensor(sample, device=cuda)].cpu().numpy()
    for j, row in zip(sample, rows):
        want = s
        for b in range(k):
            if j >> b & 1:
                want = want * xi[k - 1 - b] % FR.p
        assert limbs_to_int(row) == want, j


def test_points_to_fr_to_affine_matches_plain(cuda):
    """map_fr=False: projective points (Z = 1, random Z, identity lanes with
    Z = 0, p and 2p) -> canonical affine Fq Montgomery words, one launch."""
    from snark_verifier_tpu_torch.ff import points_to_fr, points_to_fr_plain

    rng = np.random.default_rng(77)
    q, R, n = FQ.p, 1 << 256, 37
    rows, want = [], []
    for k, (x, y) in enumerate(py_ec.rand_points(n, seed=77)):
        lam = 1 if k % 4 == 0 else int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1
        if k % 16 in (1, 2, 3):
            rows += [int.from_bytes(rng.bytes(32), "little") % (2 * q + 1) for _ in range(2)]
            rows.append((0, q, 2 * q)[k % 16 - 1])
            want += [0, 0]
            continue
        rows += [x * lam % q * R % q, y * lam % q * R % q, lam * R % q]
        want += [x * R % q, y * R % q]
    pts = _fq_words(rows, cuda).view(n, 3, 8)
    reset_launches()
    got = points_to_fr(pts, projective=True, map_fr=False)
    assert LAUNCHES["points_to_fr"] == 1 and not _field_launches()
    assert torch.equal(got.cpu(), points_to_fr_plain(pts.cpu(), projective=True, map_fr=False))
    assert _word_vals(got.view(-1, 8)) == want  # canonical Montgomery words
    assert torch.equal(got, FQW.canon(cuda_ops.affine_xy(pts)))


def _ick_stub(n_bases, seed):
    class Stub:
        transcript_initial_state = 7
        num_witness, num_challenge, evaluations, queries, accumulator_indices = [], [], [], [], []

        class quotient:
            @staticmethod
            def num_chunk():
                return 0

        class domain:
            @staticmethod
            def rotate(r):
                return 1

    stub = Stub()
    stub.num_instance = [n_bases]
    stub.instance_committing_key = {"bases": py_ec.rand_points(n_bases, seed=seed),
                                    "constant": py_ec.rand_points(1, seed=seed + 1)[0]}
    return stub


def test_ick_commitment_before_the_read_on_card(cuda):
    """The plan's instance commitment (one msm_windowed) and its absorb (one
    points_to_fr) at B = 64, against py_ec and PoseidonTranscriptPy."""
    from snark_verifier_tpu_torch.ff import FRW, int_to_limbs, np_limbs_to_words
    from snark_verifier_tpu_torch.loader.base import TorchLoader
    from snark_verifier_tpu_torch.transcript import PoseidonTranscript, PoseidonTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk.plan import commit_instances, read_proof

    class NullPcs:
        @staticmethod
        def read_proof(queries, transcript):
            return {}

    B, n = 64, 5
    stub = _ick_stub(n, 31)
    ick = stub.instance_committing_key
    rng = np.random.default_rng(31)
    vals = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)] for _ in range(B)]

    def block(mont):
        f = (lambda v: v * (1 << 256) % FR.p) if mont else (lambda v: v)
        arr = np.stack([[int_to_limbs(f(v)) for v in row] for row in vals]).astype(np.uint32)
        return torch.from_numpy(np_limbs_to_words(arr)).to(cuda)

    mont, plain = block(True), block(False)
    reset_launches()
    lanes = commit_instances(stub, plain)
    tr = PoseidonTranscript(torch.zeros((B, 0, 8), dtype=torch.int32, device=cuda),
                            torch.zeros((B, 0, 2, 8), dtype=torch.int32, device=cuda), cuda,
                            lanes=lanes)
    reads = read_proof(stub, NullPcs, [[mont[:, i] for i in range(n)]], tr, TorchLoader(B, cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["msm_windowed"] == 1 and LAUNCHES["points_to_fr"] == 1
    assert not any(v for k, v in LAUNCHES.items() if k.startswith("field_"))
    got = to_affine_int(words_to_limbs(lanes[:, 0]))
    zs = FRW.to_int(reads.values[0])
    for b in (0, 1, B - 1):
        want = py_ec.add(py_ec.msm(ick["bases"], vals[b]), ick["constant"])
        t = PoseidonTranscriptPy()
        t.common_scalar(7)
        t.common_ec_point(want)
        assert got[b] == want and int(zs[b]) == t.squeeze_challenge()


def test_ipa_batch_on_card_mixed_lanes(cuda):
    """The committed k = 11 openings at B = 48 with every third lane's eval
    moved: the accept bits are the pattern; one fr_tape, one msm_windowed,
    one points_to_fr, k + 1 poseidon_absorb; xi are the prover's."""
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.pcs.ipa import IpaOpening, batch_ipa_verify
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx

    ops, accs = fx.ipa_openings(False)
    lanes, want = [], []
    for b in range(48):
        o = ops[b % 16]
        if b % 3 == 2:
            o = IpaOpening(o.svk, o.c, o.z, (o.v + 1) % FR.p, o.scalars, o.points)
        lanes.append(o)
        want.append(b % 3 != 2)
    reset_launches()
    out, oks = batch_ipa_verify(lanes, device=cuda)
    torch.cuda.synchronize()
    assert LAUNCHES["fr_tape"] == 1 and LAUNCHES["msm_windowed"] == 1
    assert LAUNCHES["points_to_fr"] == 1 and LAUNCHES["poseidon_absorb"] == fx.K + 1
    assert not any(v for k, v in LAUNCHES.items() if k.startswith("field_"))
    assert oks.tolist() == want
    xis = FRW.to_int(out.xi.reshape(-1, 8)).reshape(48, fx.K)
    assert all([int(x) for x in xis[b]] == accs[b % 16].xi for b in range(48))


def test_ipa_family_and_decide_on_card(cuda):
    """BGH19 (4 lanes, one tampered), both IpaAs folds, and the decide at
    2^11 of an opening's and each fold's accumulator (U = H rejected)."""
    from snark_verifier_tpu_torch.pcs.ipa import (
        Bgh19Opening, IpaAccumulator, batch_bgh19_verify, batch_ipa_as_verify,
        batch_ipa_verify, decide,
    )
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx

    ops, _ = fx.bgh19_openings()
    o = ops[1]
    q = list(o.queries)
    q[0] = (q[0][0], q[0][1], (q[0][2] + 1) % FR.p)
    lanes = [ops[0], Bgh19Opening(o.svk, o.commitments, o.x, q, o.scalars, o.points)] + ops[2:]
    _, oks = batch_bgh19_verify(lanes, device=cuda)
    assert oks.tolist() == [True, False, True, True]
    dk, dk_zk = fx.ipa_keys()
    folds, _ = fx.ipa_folds()
    for d, fold in zip((dk, dk_zk), folds):
        out, ok = batch_ipa_as_verify([fold], device=cuda)
        assert ok.tolist() == [True]
        reset_launches()
        assert bool(decide(d, out.lane(0)))
        assert LAUNCHES["ipa_h_coeffs"] == 1 and LAUNCHES["bucket_reduce"] == 1
    out, ok = batch_ipa_verify(fx.ipa_openings(False)[0][:1], device=cuda)
    assert bool(ok[0]) and bool(decide(dk, out.lane(0)))
    h = limbs_to_words(from_affine_int([dk.svk.h], device=cuda))[0]
    assert not bool(decide(dk, IpaAccumulator(out.xi[0], h)))


def test_ick_keccak_read_on_card(cuda):
    """The keccak read of the ick stub at B = 64 through the recorded
    schedule: the commitment (one msm_windowed), its normalisation (one
    points_to_fr, map_fr=False) and one keccak_read; z and the next squeeze
    against EvmTranscriptPy."""
    from snark_verifier_tpu_torch.ff import FRW, int_to_limbs, np_limbs_to_words
    from snark_verifier_tpu_torch.loader.tape_loader import TapeLoader, TapeTranscript
    from snark_verifier_tpu_torch.transcript import EvmTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk.plan import (
        commit_instances, instance_label, keccak_challenges, keccak_schedule,
    )
    from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkProof

    class NullPcs:
        @staticmethod
        def read_proof(queries, transcript):
            return {}

    B, n = 64, 5
    stub = _ick_stub(n, 41)
    ick = stub.instance_committing_key
    L = TapeLoader()
    rec = TapeTranscript(L)
    PlonkProof.read(stub, [[L.input(instance_label(0, i)) for i in range(n)]], rec, NullPcs, L)
    rec.squeeze_challenge()
    sched = keccak_schedule(rec.squeezes, stub)
    rng = np.random.default_rng(41)
    vals = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)] for _ in range(B)]

    def block(mont):
        f = (lambda v: v * (1 << 256) % FR.p) if mont else (lambda v: v)
        arr = np.stack([[int_to_limbs(f(v)) for v in row] for row in vals]).astype(np.uint32)
        return torch.from_numpy(np_limbs_to_words(arr)).to(cuda)

    empty_sc = torch.zeros((B, 0, 8), dtype=torch.int32, device=cuda)
    empty_pts = torch.zeros((B, 0, 2, 8), dtype=torch.int32, device=cuda)
    mont, plain = block(True), block(False)
    reset_launches()
    chals = keccak_challenges(sched, mont, empty_sc, empty_pts, commit_instances(stub, plain))
    torch.cuda.synchronize()
    assert LAUNCHES["msm_windowed"] == 1 and LAUNCHES["points_to_fr"] == 1
    assert LAUNCHES["keccak_read"] == 1 and LAUNCHES["poseidon_absorb"] == 0
    assert not _field_launches()
    z, nxt = FRW.to_int(chals[0]), FRW.to_int(chals[1])
    for b in (0, 1, B - 1):
        t = EvmTranscriptPy()
        t.common_scalar(7)
        t.common_ec_point(py_ec.add(py_ec.msm(ick["bases"], vals[b]), ick["constant"]))
        assert [int(z[b]), int(nxt[b])] == [t.squeeze_challenge(), t.squeeze_challenge()]


def test_ick_keccak_batch_on_card_matches_oracle(cuda):
    """batch_succinct_verify(..., "shplonk", "evm") of the evmsnark protocol
    given an instance committing key (its instance column queried, an extra
    stream scalar): every lane equals the python-int verifier."""
    import copy

    from snark_verifier_tpu_torch.verifier.plonk.protocol import Query

    srs, loaded = _fixtures("evmsnark", 3)
    proto = copy.deepcopy(loaded[0].protocol)
    proto.instance_committing_key = {"bases": py_ec.rand_points(proto.num_instance[0], seed=3),
                                     "constant": py_ec.rand_points(1, seed=4)[0]}
    n_eval = len(proto.evaluations)
    proto.evaluations.append(Query(len(proto.preprocessed), 0))
    proto.queries.append(Query(len(proto.preprocessed), 0))
    snarks = [Snark(proto, s.instances, s.scalars[:n_eval] + [12345 + i] + s.scalars[n_eval:],
                    s.points) for i, s in enumerate(loaded)]
    reset_launches()
    (lhs, rhs), = batch_succinct_verify(snarks, srs, "shplonk", "evm")
    torch.cuda.synchronize()
    assert LAUNCHES["msm_windowed"] == 2 and LAUNCHES["points_to_fr"] == 1
    assert LAUNCHES["keccak_read"] == 1 and LAUNCHES["fr_tape"] == 1
    assert LAUNCHES["poseidon_absorb"] == 0 and not _field_launches()
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [succinct_verify_native(s, srs, "shplonk", "evm")[0] for s in snarks]


# ------------------------------------------------- the mesh paths (one card listed twice)


def test_msm_sharded_on_a_mesh_of_one_card_listed_twice(cuda):
    from snark_verifier_tpu_torch.parallel import Mesh, batch_msm_sharded, msm_sharded
    from snark_verifier_tpu_torch.parallel.mesh import recording

    mesh = Mesh(["cuda"] * 2, ("points",))
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{torch.cuda.current_device()}"] * 2
    pts = py_ec.rand_points(512, seed=11)
    rng = np.random.default_rng(12)
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(512)]
    reset_launches()
    with recording() as ops:
        out, ovf = msm_sharded(from_affine_int(pts), scalars_from_int(ks), mesh)
    assert out.device.type == "cuda" and not bool(ovf)
    assert to_affine_int(out) == py_ec.msm(pts, ks)
    assert LAUNCHES["add"] == 1 and LAUNCHES["bucket_reduce"] == 2
    assert [o["type"] for o in ops] == ["s32[2,3,8]", "pred[2]"]
    grid = Mesh(np.array(["cuda"] * 4).reshape(2, 2), ("batch", "points"))
    P = from_affine_int(pts[:256]).reshape(4, 64, 3, 16)
    S = scalars_from_int(ks[:256]).reshape(4, 64, 16)
    outs, ovfs = batch_msm_sharded(P, S, grid)
    assert not bool(ovfs.any())
    assert to_affine_int(outs) == [py_ec.msm(pts[64 * b:64 * (b + 1)], ks[64 * b:64 * (b + 1)])
                                   for b in range(4)]


def test_batch_verify_sharded_on_a_mesh_of_one_card_listed_twice(cuda):
    from snark_verifier_tpu_torch.parallel import Mesh, batch_verify_sharded

    srs, snarks = _fixtures("snark", 4)
    s1 = snarks[1]
    snarks[1] = Snark(s1.protocol, [list(c) for c in s1.instances], s1.scalars, s1.points)
    snarks[1].instances[0][0] = (snarks[1].instances[0][0] + 1) % FR.p
    reset_launches()
    timings = {}
    oks = batch_verify_sharded(snarks, srs, Mesh(["cuda"] * 2, ("batch",)), timings=timings)
    assert oks.device.type == "cuda" and oks.tolist() == [True, False, True, True]
    assert LAUNCHES["miller_loop"] == 2 and LAUNCHES["final_exp"] == 2
    assert LAUNCHES["fr_tape"] == 2 and LAUNCHES["msm_windowed"] == 2
    assert set(timings) == {"succinct_s", "decide_s", "stack_s", "plan_s", "read_s",
                            "gather_s", "fr_tape_s", "msm_s"}
    assert oks.tolist() == batch_verify(snarks, srs).tolist()


# ------------------------------------------- host proving, commitments on the card


@functools.lru_cache(maxsize=None)
def _k10_srs():
    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    return load_params(str(d / "srs.bin"))


@pytest.mark.parametrize("n", [0, 1, 4, 5, 1023, 1024])
def test_srs_commit_on_card_matches_py_ec(cuda, n):
    srs = _k10_srs()
    rng = np.random.default_rng(n)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    reset_launches()
    got = srs.commit(coeffs)
    assert got == py_ec.msm(srs.g1_powers[:n], coeffs)
    assert got is None or all(type(v) is int for v in got)
    assert LAUNCHES["bucket_reduce"] == (n > 0)
    assert srs.commit([0] * 9) is None


@pytest.mark.parametrize("n", [1, 4, 5, 1023, 1024, 2048])
def test_ipa_key_commit_on_card_matches_py_ec(cuda, n):
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx

    pk = fx.ipa_proving_key()
    rng = np.random.default_rng(100 + n)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    omega = int.from_bytes(rng.bytes(32), "little") % FR.p
    assert pk.commit(coeffs) == py_ec.msm(pk.g[:n], coeffs)
    assert pk.commit(coeffs, omega) == py_ec.add(py_ec.msm(pk.g[:n], coeffs),
                                                 py_ec.scalar_mul(pk.s, omega))
    assert pk.commit([0] * n) is None


def test_standard_plonk_proof_on_card_equals_cpu(cuda):
    from snark_verifier_tpu_torch.sdk.srs import toy_srs
    from snark_verifier_tpu_torch.system.standard_plonk import (
        StandardPlonk,
        build_protocol,
        gen_snark,
    )

    srs = toy_srs(32)
    c = StandardPlonk.rand(3, seed=7)
    reset_launches()
    protocol = build_protocol(c, srs)
    on_card = gen_snark(c, protocol, srs, "shplonk")
    # one msm a commitment: 6 fixed, 3 witness, the quotient's chunks, W and W'
    assert LAUNCHES["bucket_reduce"] == 6 + 3 + protocol.quotient.num_chunk() + 2
    on_cpu = gen_snark(c, build_protocol(c, srs, device="cpu"), srs, "shplonk", device="cpu")
    assert on_card.to_json() == on_cpu.to_json()


# ------------------------------------------------ the CLI on the card


@pytest.mark.parametrize("argv, launched", [
    (["verify"], ("fr_tape", "msm_windowed", "miller_loop", "final_exp")),
    (["verify", "--scheme", "gwc"], ("fr_tape", "msm_windowed", "miller_loop", "final_exp")),
    (["aggregate", "--n", "4"], ("fr_tape", "fr_powers", "msm_windowed", "miller_loop")),
    (["tree", "--n", "16", "--fanout", "4"], ("fr_tape", "fr_powers", "msm_windowed",
                                               "miller_loop")),
])
def test_cli_commands_on_card(cuda, capsys, argv, launched):
    """verify, aggregate and tree through `__main__.main` on the card: each
    prints PASS after its own checks (a tampered proof or leaf rejects) and
    launches its path's kernels; the cost meter counts the fold and the
    decide by the JAX package's rules."""
    from snark_verifier_tpu_torch.__main__ import main
    from snark_verifier_tpu_torch.utils.timing import METER

    METER.spans.pop(argv[0], None)
    reset_launches()
    main(argv)
    torch.cuda.synchronize()
    out = capsys.readouterr()
    assert "PASS" in out.out and "# cost-meter" in out.err
    for k in launched:
        assert LAUNCHES[k] > 0, (k, dict(LAUNCHES))
    span = METER.spans[argv[0]]
    if argv[0] == "tree":  # two trees of 4 group folds of 4 and one root fold of 4
        assert span == {"msm": 20, "msm_terms": 80, "pairing": 4}
    if argv[0] == "aggregate":  # one batch decide, two folds of 4, two decides
        assert span == {"msm": 4, "msm_terms": 16, "pairing": 6}


# ------------------------------------------------ a batch's inputs as one packed upload


def _uploads_one_at_a_time(snarks, device):
    """The streams and instances as the three uploads of pageable blocks
    that the packed upload replaced, instances one python int at a time."""
    p, R = FR.p, 1 << 256

    def words(vals):
        arr = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals],
                       np.uint32).view(np.int32)
        return torch.from_numpy(arr.reshape(len(snarks), -1, 8)).to(device)

    pairs = [s.host_streams() for s in snarks]
    vals = [v % p for s in snarks for col in s.instances for v in col]
    return [torch.from_numpy(np.stack([q[i] for q in pairs])).to(device) for i in (0, 1)] + [
        words([v * R % p for v in vals]), words(vals)]


def test_packed_upload_equals_the_three_uploads_on_card(cuda):
    """`_pack_inputs` at B = 1,024 (16 fixtures tiled) and B = 1: every
    view on the card, contiguous, 32-byte aligned, word for word the
    blocks the separate uploads gave; one packed upload, no host wait.
    The standalone stacks give the same words."""
    from snark_verifier_tpu_torch._launch import COUNTERS
    from snark_verifier_tpu_torch.sdk import aggregation as agg

    _, base = _fixtures("snark", 16)
    for B in (1024, 1):
        snarks = [base[i % 16] for i in range(B)]
        want = _uploads_one_at_a_time(snarks, cuda)
        reset_launches()
        views = agg._pack_inputs(snarks, cuda, plain=True)
        assert COUNTERS["packed_uploads"] == 1 and COUNTERS["host_waits"] == 0
        torch.cuda.synchronize()
        assert len({v.untyped_storage().data_ptr() for v in views}) == 1
        for got, w in zip(views, want):
            assert got.device == w.device and got.is_contiguous() and got.data_ptr() % 32 == 0
            assert torch.equal(got, w)
        sc, pts = agg._stack_streams(snarks, cuda)
        assert torch.equal(sc, want[0]) and torch.equal(pts, want[1])
        assert torch.equal(agg._instance_block(snarks, cuda), want[2])
        assert torch.equal(agg._instance_block(snarks, cuda, mont=False), want[3])


def test_packed_blocks_in_flight_are_never_overwritten_on_card(cuda):
    """Two batches packed while the stream is held back (their copies still
    queued when the host writes the next block), then two batch verifies
    back to back with no synchronize between them, the second with two
    tampered lanes: every block arrives as written and every bit is the
    python-int verifier's."""
    from snark_verifier_tpu_torch.sdk import aggregation as agg

    srs, base = _fixtures("snark", 8)
    tampered = []
    for i in (0, 5):
        s = base[i]
        inst = [list(c) for c in s.instances]
        inst[0][0] = (inst[0][0] + 1) % FR.p
        tampered.append(Snark(s.protocol, inst, s.scalars, s.points))
    first = [base[i % 8] for i in range(64)]
    second = [tampered[0] if i % 16 == 3 else tampered[1] if i % 16 == 9 else base[(i * 3) % 8]
              for i in range(64)]
    want = [_uploads_one_at_a_time(b, cuda) for b in (first, second)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    got = [agg._pack_inputs(b, cuda, plain=False) for b in (first, second, first, second)]
    torch.cuda.synchronize()
    for k, views in enumerate(got):
        assert all(torch.equal(g, w) for g, w in zip(views, want[k % 2])), k

    def oracle(s):
        (lhs, rhs), = succinct_verify_native(s, srs)
        return pp.pairing_check([(lhs, srs.g2), (rhs, pp.g2_neg(srs.s_g2))])

    bits = {id(s): oracle(s) for s in base + tampered}
    assert [bits[id(s)] for s in tampered] == [False, False]
    torch.cuda._sleep(int(2e8))
    oks = [batch_verify(b, srs) for b in (first, second)]
    for b, ok in zip((first, second), oks):
        assert ok.tolist() == [bits[id(s)] for s in b]


def test_packed_uploads_and_host_waits_per_batch_on_card(cuda, monkeypatch):
    """A Poseidon batch verify makes one packed upload and three host waits
    (the sponge's initial state, the MSM's rows and bases); the
    instance-committing keccak batch one packed upload and two waits.  No
    wait is left at the stack, and every wait is a span."""
    import contextlib
    import copy

    from snark_verifier_tpu_torch._launch import COUNTERS
    from snark_verifier_tpu_torch.utils import timing
    from snark_verifier_tpu_torch.verifier.plonk.protocol import Query

    seen = []

    @contextlib.contextmanager
    def rec(name):
        seen.append(name)
        yield

    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(timing, "_record", rec)
    srs, snarks = _fixtures("snark", 3)
    _, loaded = _fixtures("evmsnark", 3)
    proto = copy.deepcopy(loaded[0].protocol)
    proto.instance_committing_key = {"bases": py_ec.rand_points(proto.num_instance[0], seed=3),
                                     "constant": py_ec.rand_points(1, seed=4)[0]}
    n_eval = len(proto.evaluations)
    proto.evaluations.append(Query(len(proto.preprocessed), 0))
    proto.queries.append(Query(len(proto.preprocessed), 0))
    ick = [Snark(proto, s.instances, s.scalars[:n_eval] + [12345 + i] + s.scalars[n_eval:],
                 s.points) for i, s in enumerate(loaded)]
    for run, waits in ((lambda: batch_verify(snarks, srs), 3),
                       (lambda: batch_succinct_verify(ick, srs, "shplonk", "evm"), 2)):
        for _ in range(2):  # the first call records the plan
            seen.clear()
            reset_launches()
            run()
            torch.cuda.synchronize()
            sites = [n for n in seen if n.startswith("svt::wait.")]
            assert COUNTERS["packed_uploads"] == 1 and "svt::verify.upload" in seen
            assert COUNTERS["host_waits"] == len(sites) == waits, sites
            assert not {"svt::wait.stack_scalars", "svt::wait.stack_points",
                        "svt::wait.instances"} & set(sites)
