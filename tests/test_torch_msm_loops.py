"""The verify MSM and the MSM's bucket reduction -- on the card the kernels
`svt_msm_windowed` and `svt_bucket_reduce` (csrc/msm_loops.cu) -- on the CPU:

* their plain versions (`msm/cuda_ops.py::msm_windowed_plain`,
  `msm/pippenger.py::bucket_reduce_plain`) against the JAX package's
  `CurveOps.msm_windowed` and `_weighted_bucket_sum` + `_horner`, and against
  the python-int oracle;
* a schedule twin of each kernel: the same teams, lanes, tables, ladders,
  scans and trees in the same order, with the lanes as a batch axis and a
  warp shuffle as an index permutation, held against python ints.  No CUDA
  compiler runs here, so this is where the kernels' algorithm is proven;
  the card tests (tests/test_torch_gpu.py) hold the kernels to the plain
  versions;
* the wrappers' contract on the CPU.

Tolerance: exact, points in affine form (the orders of summation differ, so
projective words may)."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snark_verifier_tpu.ec import G1 as JG1, from_affine_int as j_from_affine
from snark_verifier_tpu.ec import to_affine_int as j_to_affine
from snark_verifier_tpu.msm import pippenger as jpip
from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec, to_affine_int
from snark_verifier_tpu_torch.ec import words_to_limbs
from snark_verifier_tpu_torch.ff import FR, digits4
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.msm import pippenger as pip

add, double = cuda_ops.add_plain, cuda_ops.double_plain
INF = cuda_ops.identity((), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(aff):
    """Affine points (None: the identity) -> (len, 3, 8) projective words."""
    return limbs_to_words(from_affine_int(aff))


def _affine(words):
    return to_affine_int(words_to_limbs(words))


def _scalar_words(ints):
    """Python ints < 2^256 -> (len, 8) int32 words, least significant first."""
    raw = np.frombuffer(b"".join(int(k).to_bytes(32, "little") for k in ints), dtype="<i4")
    return torch.from_numpy(raw.reshape(-1, 8).copy())


# ------------------------------------------------ the kernels' schedules

WINDOWS = 64  # csrc/msm_loops.cu: MSMW_WINDOWS; one warp per proof


def _digit(words, w):
    """Digit w (4 bits) of (..., 8) scalar words: nibble w % 8 of word w / 8."""
    return ((words[..., w >> 3].to(torch.int64) & 0xFFFFFFFF) >> (4 * (w & 7))) & 15


def msm_windowed_schedule(pts, scalars):
    """svt_msm_windowed's order of operations: (B, n, 3, 8), (B, n, 8) ->
    (B, 3, 8).  A warp per proof; in each group of 32 bases lane i owns one
    (the identity past n), builds its table T[d] = d·P by a chain of adds,
    runs its own ladder over the 64 windows (MSB first: 4 doublings, then
    its entry added) and adds the ladder into its sum; a shuffle tree sums
    the warp."""
    B, n = pts.shape[:2]
    lane = torch.arange(32)
    rows = torch.arange(B)[:, None]
    total = INF.expand(B, 32, 3, 8)
    for g0 in range(0, n, 32):
        i = g0 + lane
        live = i < n
        ii = torch.where(live, i, 0)
        base = torch.where(live[None, :, None, None], pts[:, ii], INF)
        tab = [INF.expand_as(base), base]
        for _ in range(2, 16):
            tab.append(add(tab[-1], base))
        tab = torch.stack(tab, 2)  # (B, 32, 16, 3, 8)
        sk = scalars[:, ii]
        acc = tab[rows, lane, torch.where(live, _digit(sk, WINDOWS - 1), 0)]
        for w in range(WINDOWS - 2, -1, -1):
            for _ in range(4):
                acc = double(acc)
            acc = add(acc, tab[rows, lane, torch.where(live, _digit(sk, w), 0)])
        total = add(total, acc)
    for m in (16, 8, 4, 2, 1):
        total = add(total, total[:, lane ^ m])
    return total[:, 0]


def bucket_reduce_schedule(buckets):
    """svt_bucket_reduce's order of operations: (32, 256, 3, 8) -> (3, 8).
    A warp per window; lane l's block of buckets 8l .. 8l+7 gives T_l (their
    sum) and U_l = Σ_k k·B_{8l+k} by running sums from the top; a suffix scan
    over the lanes (shfl_down: a lane past the last gets its own value back)
    makes S_l = Σ_{m>=l} T_m; lane l adds 8·S_l (lane 0: the identity) to
    U_l; a shuffle tree sums the lanes; window w doubles its sum 8w times;
    the last warp sums the 32 window sums with one more tree."""
    lane = torch.arange(32)
    blk = buckets.view(32, 32, 8, 3, 8)  # (window, lane, k)
    run = blk[:, :, 7]
    u = run
    for k in range(6, 0, -1):
        run = add(run, blk[:, :, k])
        u = add(u, run)
    run = add(run, blk[:, :, 0])
    d = 1
    while d < 32:
        q = run[:, (lane + d).clamp(max=31)]
        run = torch.where((lane + d < 32)[None, :, None, None], add(run, q), run)
        d *= 2
    for _ in range(3):
        run = double(run)
    run = torch.where((lane == 0)[None, :, None, None], INF, run)
    u = add(u, run)
    for s in (16, 8, 4, 2, 1):
        u = add(u, u[:, lane ^ s])
    win = u[:, 0]  # every lane holds its window's sum; lane 0 stores it
    for j in range(8 * 31):
        win = torch.where((8 * lane > j)[:, None, None], double(win), win)
    for s in (16, 8, 4, 2, 1):  # the last warp: lane l holds window l's sum
        win = add(win, win[lane ^ s])
    return win[0]


# ------------------------------------------------------- the verify MSM

N_CASES = (1, 2, 26, 32, 33)


def _bases(n, seed):
    """n affine bases with the identity and a repeated base among them."""
    pts = py_ec.rand_points(n, seed=seed)
    if n >= 2:
        pts[1] = None
    if n >= 4:
        pts[3] = pts[2]
    if n >= 33:
        pts[32] = pts[0]  # the second group's only base repeats the first
    return pts


def _scalars(n, seed):
    """n scalars < 2^256 with 0, 1, r - 1 and all 64 digits 15 among them."""
    rng = random.Random(seed)
    ks = [rng.randrange(FR.p) for _ in range(n)]
    for i, k in enumerate((FR.p - 1, 0, (1 << 256) - 1, 1)):
        if i < n:
            ks[i] = k
    return ks


def test_msm_windowed_plain_matches_jax():
    """Two windows of digits, n = 1, 2, 26, 32, 33: one JAX call over 33
    bases per row, the rows past n holding the identity with digit 0."""
    N, nw = max(N_CASES), 2
    rng = np.random.default_rng(40)
    aff = []
    digits = np.zeros((len(N_CASES), N, nw), dtype=np.uint32)
    for r, n in enumerate(N_CASES):
        aff.append(_bases(n, 41 + r) + [None] * (N - n))
        digits[r, :n] = rng.integers(0, 16, size=(n, nw))
        digits[r, 0] = 15  # all digits 15
        if n > 2:
            digits[r, 2] = 0
    jpts = j_from_affine([p for row in aff for p in row]).reshape(len(N_CASES), N, 3, -1)
    want = j_to_affine(jax.jit(lambda p, d: JG1.msm_windowed(p, d, c=4))(
        jpts, jnp.asarray(digits)))
    for r, n in enumerate(N_CASES):
        pts = _words(aff[r][:n]).view(1, n, 3, 8)
        got = cuda_ops.msm_windowed_plain(pts, torch.from_numpy(digits[r:r + 1, :n].astype(np.int64)), c=4)
        ks = [sum(int(d) << (4 * w) for w, d in enumerate(row)) for row in digits[r, :n]]
        assert _affine(got) == [want[r]] == [py_ec.msm(aff[r][:n], ks)]


@pytest.mark.parametrize("n", N_CASES)
def test_msm_windowed_and_its_schedule_match_oracle(n):
    """All 64 windows, two proofs: the wrapper (on the CPU, the plain
    version over digits4) and the kernel's schedule twin against python
    ints; 33 bases make the kernel's second group of bases, its base 32 a
    repeat of base 0."""
    aff = [_bases(n, 50 + n), py_ec.rand_points(n, seed=60 + n)]
    kss = [_scalars(n, 70 + n), _scalars(n, 80 + n)[::-1]]
    pts = torch.stack([_words(a) for a in aff])
    sc = torch.stack([_scalar_words(ks) for ks in kss])
    want = [py_ec.msm(a, [k % FR.p for k in ks]) for a, ks in zip(aff, kss)]
    assert _affine(cuda_ops.msm_windowed(pts, sc)) == want
    assert _affine(msm_windowed_schedule(pts, sc)) == want


# ----------------------------------------------------- the bucket reduction


def _pool_buckets(k):
    """(W, nb) ints -> (W, nb, 3, 8) bucket words k·G (0 the identity)."""
    pool = _words([py_ec.scalar_mul(py_ec.G1_GEN, j) for j in range(int(k.max()) + 1)])
    return pool[torch.from_numpy(k)]


def _reduce_oracle(k, c):
    """The reduction of buckets k·G by python ints."""
    total = sum((b * int(k[w, b])) << (c * w) for w in range(k.shape[0])
                for b in range(k.shape[1]))
    return py_ec.scalar_mul(py_ec.G1_GEN, total % FR.p)


def _edge_windows(W, nb, top_range, seed):
    """Bucket multiples with an empty window (0), a window of equal buckets
    (1), a padded top window (identity above top_range) and random others."""
    k = np.random.default_rng(seed).integers(0, 8, size=(W, nb))
    k[0] = 0
    k[1] = 5
    k[-1, top_range:] = 0
    return k


def test_bucket_reduce_plain_matches_jax():
    """c = 2, three windows of four buckets: an empty window, equal buckets
    and a padded top window, against the JAX package's weighted sums and
    Horner loop."""
    k = _edge_windows(3, 4, 2, 90)
    buckets = _pool_buckets(k)
    jb = j_from_affine(_affine(buckets.view(-1, 3, 8))).reshape(3, 4, 3, -1)
    want = j_to_affine(jax.jit(
        lambda b: jpip._horner(JG1, jpip._weighted_bucket_sum(JG1, b), 2))(jb))
    got = pip.bucket_reduce_plain(buckets, 2)
    assert _affine(got) == [want] == [_reduce_oracle(k, 2)]


def test_bucket_reduce_and_its_schedule_match_oracle():
    """The MSM's (32, 256) at c = 8 with its top window padded past bucket
    48: the wrapper (the plain version on the CPU) and the kernel's schedule
    twin against python ints."""
    k = _edge_windows(32, 256, pip.top_range(8), 91)
    buckets = _pool_buckets(k)
    want = _reduce_oracle(k, 8)
    assert _affine(pip.bucket_reduce(buckets, 8)) == [want]
    assert _affine(bucket_reduce_schedule(buckets)) == want


@pytest.mark.parametrize("kind", ["empty", "one bucket per window"])
def test_bucket_reduce_schedule_edges(kind):
    """All buckets the identity; one bucket per window at the lane blocks'
    edges (8l and 8l + 7, lanes 0, 1, 15, 16 and 31), bucket 0 (weight 0)
    among them."""
    k = np.zeros((32, 256), dtype=np.int64)
    if kind != "empty":
        edges = (0, 7, 8, 15, 120, 127, 128, 135, 248, 255, 1)
        for w in range(32):
            k[w, edges[w % len(edges)]] = 1 + w % 7
    got = bucket_reduce_schedule(_pool_buckets(k))
    assert _affine(got) == _reduce_oracle(k, 8)


# ------------------------------------------------------------ the wrappers


def test_wrappers_contract_on_cpu():
    pts = _words(py_ec.rand_points(3, seed=95)).view(1, 3, 3, 8)
    sc = _scalar_words([7, 8, 9]).view(1, 3, 8)
    reset_launches()
    got = cuda_ops.msm_windowed(pts, sc)
    assert torch.equal(got, cuda_ops.msm_windowed_plain(pts, digits4(sc)))
    assert LAUNCHES["msm_windowed"] == 0 and LAUNCHES["add"] == 0
    with pytest.raises(ValueError):
        cuda_ops.msm_windowed(pts, sc, c=5)
    with pytest.raises(ValueError):
        cuda_ops.msm_windowed(pts, sc[:, :2].contiguous())
    with pytest.raises(ValueError):
        cuda_ops.msm_windowed(pts[0], sc)
    with pytest.raises(TypeError):
        cuda_ops.msm_windowed(pts, sc.long())
    buckets = cuda_ops.identity((32, 256), "cpu").contiguous()
    with pytest.raises(ValueError):
        pip.bucket_reduce(buckets, 4)  # (32, 256) is c = 8's shape
    with pytest.raises(ValueError):
        pip.bucket_reduce(buckets[:, :128].contiguous(), 8)
    assert _affine(pip.bucket_reduce(buckets, 8)) == [None]
    assert LAUNCHES["bucket_reduce"] == 0 and LAUNCHES["double"] == 0
