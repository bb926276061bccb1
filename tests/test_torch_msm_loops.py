"""The verify MSM and the MSM's bucket reduction -- on the card the kernels
`svt_msm_windowed` and `svt_bucket_reduce` (csrc/msm_loops.cuh) -- on the CPU:

* their plain versions (`msm/cuda_ops.py::msm_windowed_plain`,
  `msm/pippenger.py::bucket_reduce_plain`) against the JAX package's
  `CurveOps.msm_windowed` and `_weighted_bucket_sum` + `_horner`, and against
  the python-int oracle;
* a schedule twin of each kernel: the same layouts, teams, tables,
  ladders, scans and trees in the same order, with the teams as a batch
  axis and an exchange through shared memory as an index permutation, held
  against python ints (tests/test_torch_g1_team_schedule.py runs the
  kernels' own C++);  No CUDA
  compiler runs here, so this is where the kernels' algorithm is proven;
  the card tests (tests/test_torch_gpu.py) hold the kernels to the plain
  versions;
* the wrappers' contract on the CPU.

Tolerance: exact, points in affine form (the orders of summation differ, so
projective words may)."""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snark_verifier_tpu.ec import G1 as JG1, from_affine_int as j_from_affine
from snark_verifier_tpu.ec import to_affine_int as j_to_affine
from snark_verifier_tpu.msm import pippenger as jpip
from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
from snark_verifier_tpu_torch.ec import from_affine_int, glv, limbs_to_words, py_ec
from snark_verifier_tpu_torch.ec import to_affine_int
from snark_verifier_tpu_torch.ec import words_to_limbs
from snark_verifier_tpu_torch.ff import FQ_FIELD, FR, digits4
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

WINDOWS = 32  # csrc/msm_loops.cuh: MSMW_WINDOWS, 4-bit windows of a GLV half
BETA = limbs_to_words(FQ_FIELD.from_int([glv.BETA]))[0]  # Montgomery words


def _ints(words):
    """(N, 8) int32 words -> N python ints."""
    raw = words.contiguous().numpy().astype("<i4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(words.shape[0])]


def _neg_y(pts, flip):
    """(N, 3, 8) points with y negated (2p - y, the lazy negation) where flip."""
    y = limbs_to_words(FQ_FIELD.neg(words_to_limbs(pts[:, 1])))
    return torch.cat([pts[:, :1], torch.where(flip[:, None], y, pts[:, 1])[:, None],
                      pts[:, 2:]], 1)


def msm_windowed_schedule(pts, scalars, team, per_block):
    """svt_msm_windowed's order of operations at layout (team, per_block):
    (B, n, 3, 8), (B, n, 8) -> (B, 3, 8).  Teams are the batch axis here (a
    team's group operations are one lane's, word for word: csrc/g1_team.cuh,
    tests/test_torch_g1_team_schedule.py).  A block holds per_block proofs,
    tp teams each (`cuda_ops.msm_windowed_geometry`); team t of a proof
    runs the ladders of bases t, t + tp, ... (the identity and the scalar 0
    past n or past the last proof): the GLV split k = k1 + λ k2 (`glv.split`),
    its table T[d] = d·(±P) by a chain of adds and U[d] = φ(T[d]) with y
    negated where the halves' signs differ, the 32 windows MSB first (the
    top one T + U, then 4 doublings, T, U), the ladder added into the
    team's sum; then a tree over the proof's teams, level d adding team
    t + d into team t for t a multiple of 2d."""
    B, n = pts.shape[:2]
    tp, _ = cuda_ops.msm_windowed_geometry(n, team, per_block)
    nblk = -(-B // per_block)
    b = torch.arange(nblk * per_block).repeat_interleave(tp)  # each team's proof
    t = torch.arange(tp).repeat(nblk * per_block)
    rows = torch.arange(b.numel())
    mine = b < B
    bb = torch.where(mine, b, 0)
    total = INF.expand(b.numel(), 3, 8)
    for i0 in range(0, n, tp):
        i = i0 + t
        live = mine & (i < n)
        ii = torch.where(live, i, 0)
        base = torch.where(live[:, None, None], pts[bb, ii], INF)
        ks = [k if ok else 0 for k, ok in zip(_ints(scalars[bb, ii]), live.tolist())]
        halves = [glv.split(k) for k in ks]
        n1 = torch.tensor([k1 < 0 for k1, _ in halves])
        n2 = torch.tensor([k2 < 0 for _, k2 in halves])
        d1, d2 = ([[(abs(h[j]) >> (4 * w)) & 15 for w in range(WINDOWS)] for h in halves]
                  for j in (0, 1))
        d1, d2 = torch.tensor(d1).view(-1, WINDOWS), torch.tensor(d2).view(-1, WINDOWS)
        base = _neg_y(base, n1)
        tab = [INF.expand_as(base), base]
        for _ in range(2, 16):
            tab.append(add(tab[-1], base))
        tab = torch.stack(tab, 1)  # (teams, 16, 3, 8)
        flat = tab.reshape(-1, 3, 8)
        x = limbs_to_words(FQ_FIELD.mul(words_to_limbs(flat[:, 0]), words_to_limbs(BETA)))
        tau = _neg_y(torch.cat([x[:, None], flat[:, 1:]], 1), (n1 != n2).repeat_interleave(16))
        tau = tau.view_as(tab)
        acc = add(tab[rows, d1[:, -1]], tau[rows, d2[:, -1]])
        for w in range(WINDOWS - 2, -1, -1):
            for _ in range(4):
                acc = double(acc)
            acc = add(add(acc, tab[rows, d1[:, w]]), tau[rows, d2[:, w]])
        total = add(total, acc)
    total = total.view(nblk * per_block, tp, 3, 8)
    idx = torch.arange(tp)
    d = 1
    while d < tp:
        adds = (idx % (2 * d) == 0) & (idx + d < tp)
        summed = add(total, total[:, torch.where(adds, idx + d, idx)])
        total = torch.where(adds[None, :, None, None], summed, total)
        d *= 2
    return total[:B, 0]


def bucket_reduce_schedule(buckets):
    """svt_bucket_reduce's order of operations: (32, 256, 3, 8) -> (3, 8).
    A block per window, 32 teams (a team's group operations are one lane's,
    word for word: the batch axis here); team l's block of buckets
    8l .. 8l+7 gives T_l (their sum) and U_l = Σ_k k·B_{8l+k} by running
    sums from the top; a suffix scan over the teams through shared memory
    (a team past the last keeps its value) makes S_l = Σ_{m>=l} T_m; team l
    adds 8·S_l (team 0: the identity) to U_l; an xor tree sums the teams;
    window w's team 0 doubles its sum 8w times; the last block sums the 32
    window sums with one more xor tree."""
    lane = torch.arange(32)  # the teams
    blk = buckets.view(32, 32, 8, 3, 8)  # (window, team, k)
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
    win = u[:, 0]  # every team holds its window's sum; team 0 stores it
    for j in range(8 * 31):
        win = torch.where((8 * lane > j)[:, None, None], double(win), win)
    for s in (16, 8, 4, 2, 1):  # the last block: team l holds window l's sum
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


def _layouts(B, n):
    """One lane a ladder with two proofs a block; teams of 6 with two proofs
    a block (at n > 20 a team loops over its proof's bases); the wrapper's
    layout for a card of 132 SMs."""
    return sorted({(1, 2), (6, 2), cuda_ops.msm_windowed_layout(B, n, 132)})


@pytest.mark.parametrize("n", N_CASES)
def test_msm_windowed_and_its_schedule_match_oracle(n):
    """Three proofs (the second block of two holds one): the wrapper (on the
    CPU, the plain version over the 64 windows of digits4) and the kernel's
    schedule twin (32 windows of each GLV half) at three layouts against
    python ints; 33 bases make a proof's base 32 a repeat of base 0."""
    aff = [_bases(n, 50 + n), py_ec.rand_points(n, seed=60 + n), _bases(n, 65 + n)]
    kss = [_scalars(n, 70 + n), _scalars(n, 80 + n)[::-1], _scalars(n, 85 + n)]
    pts = torch.stack([_words(a) for a in aff])
    sc = torch.stack([_scalar_words(ks) for ks in kss])
    want = [py_ec.msm(a, [k % FR.p for k in ks]) for a, ks in zip(aff, kss)]
    assert _affine(cuda_ops.msm_windowed(pts, sc)) == want
    for layout in _layouts(3, n):
        assert _affine(msm_windowed_schedule(pts, sc, *layout)) == want, layout


def test_msm_windowed_schedule_without_bases():
    """n = 0: every proof's sum is the identity (the kernel's C++ at n = 0:
    tests/test_torch_g1_team_schedule.py)."""
    pts = torch.zeros((3, 0, 3, 8), dtype=torch.int32)
    sc = torch.zeros((3, 0, 8), dtype=torch.int32)
    for layout in _layouts(3, 0):
        assert _affine(msm_windowed_schedule(pts, sc, *layout)) == [None] * 3


def test_msm_windowed_layouts():
    """The wrapper's choice on a card of 132 SMs at the seven shapes
    kernel_compare.py measured: one lane a ladder where the ladders fill the
    card, teams of 6 where a few proofs leave it idle; one lane a ladder
    again where a proof's bases outnumber a block's 40 teams; every
    layout's blocks hold whole proofs within 8 warps and fill the card
    before an SM takes a second."""
    sms = 132
    for B, n in ((1024, 26), (1024, 34), (1024, 17), (1, 41), (1, 300)):
        assert cuda_ops.msm_windowed_layout(B, n, sms)[0] == 1, (B, n)
    for B, n in ((1024, 4), (64, 32), (2, 32), (1, 26), (1, 1), (1, 40)):
        assert cuda_ops.msm_windowed_layout(B, n, sms)[0] == 6, (B, n)
    assert cuda_ops.msm_windowed_layout(1024, 26, sms) == (1, 8)
    for B in (1, 2, 33, 64, 1024, 4096):
        for n in (0, 1, 4, 17, 26, 34, 300):
            for team in cuda_ops.MSMW_TEAMS:
                per_block = cuda_ops.msm_windowed_per_block(B, n, team, sms)
                tp, warps = cuda_ops.msm_windowed_geometry(n, team, per_block)
                assert 1 <= warps <= cuda_ops.MSMW_MAX_WARPS
                assert tp == n or (per_block == 1 and tp < n) or n == 0
                whole_fit = per_block * max(n, 1) <= cuda_ops.MSMW_MAX_WARPS * (32 // team)
                assert per_block == 1 or whole_fit
                assert per_block <= -(-B // sms)  # at least min(B, sms) blocks


# ------------------------------------------------------ the GLV split

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"


def test_glv_constants_are_cube_roots_with_phi_g_lambda_g():
    """β and λ are nontrivial cube roots of unity in Fq and Fr, φ(G) = λ·G,
    and φ(P) = λ·P on random points; the basis vectors are in the lattice
    and span it (determinant r)."""
    p, r = FQ_FIELD.spec.p, FR.p
    assert glv.BETA != 1 and pow(glv.BETA, 3, p) == 1
    assert glv.LAMBDA != 1 and pow(glv.LAMBDA, 3, r) == 1
    for pt in [py_ec.G1_GEN] + py_ec.rand_points(3, seed=5):
        assert (glv.BETA * pt[0] % p, pt[1]) == py_ec.scalar_mul(pt, glv.LAMBDA)
    for a, b in ((glv.A1, glv.B1), (glv.A2, glv.B2)):
        assert (a + b * glv.LAMBDA) % r == 0
        assert max(abs(a), abs(b)) < 1 << 128
    assert glv.A1 * glv.B2 - glv.A2 * glv.B1 == r


def test_glv_split_recombines_within_the_bound():
    """k1 + λ·k2 ≡ k (mod r) with |k1|, |k2| < 2^127 for random scalars and
    the edges 0, 1, λ, r - 1, r - 2 and 2^256 - 1 (the kernel's 32 windows
    of 4 bits, the top one's digit below 8)."""
    rng = random.Random(17)
    ks = [rng.randrange(1 << 256) for _ in range(2000)] + [rng.randrange(FR.p) for _ in range(2000)]
    ks += [0, 1, glv.LAMBDA, FR.p - 1, FR.p - 2, (1 << 256) - 1, FR.p // 2, 1 << 255]
    for k in ks:
        k1, k2 = glv.split(k)
        assert (k1 + glv.LAMBDA * k2 - k) % FR.p == 0
        assert abs(k1) < 1 << 127 and abs(k2) < 1 << 127, k


def test_glv_kernel_literals_match_the_derivation():
    """csrc/msm_loops.cuh's GLV_* words are ec/glv.py's kernel_constants()."""
    src = (CSRC / "msm_loops.cuh").read_text()
    for name, words in glv.kernel_constants().items():
        m = re.search(name + r"\[[A-Z_0-9]*\] = \{(.*?)\};", src, re.S)
        assert m, name
        got = [int(w.strip().rstrip("u"), 16) for w in m.group(1).split(",") if w.strip()]
        assert got == words, name


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
    for layout in ((4, 1), (6, 0), (1, 257)):  # a team size or block the kernel lacks
        with pytest.raises(ValueError):
            cuda_ops._msm_windowed_at(pts, sc, *layout)
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
