"""The port's group-law kernels and their plain PyTorch twins: the
counterpart of the JAX package's `msm/pallas_ops.py`, plus the verify-path
drivers built on them.

Points are (..., 3, 8) int32 tensors in the kernels' word layout (ec/g1.py).

| wrapper | CUDA kernel | replaces (JAX package) |
| --- | --- | --- |
| `add` | `svt_g1_add` (msm_kernels.cu) | `msm/pallas_ops.py::add` :178 |
| `double` | `svt_g1_double` (msm_kernels.cu) | `msm/pallas_ops.py::double` :657 |
| `fold_buckets`, `fold_buckets_split` | `svt_fold_buckets` (msm_kernels.cu) | `msm/pippenger.py::_fold_buckets_pallas` (gather + `fold_buckets_grid_pk` :490 / `fold_buckets_grid` :560) |
| `fold_level`, `fold_halving`, `fold_grid` | `svt_fold_segments` (fold_kernels.cu) | `_pallas_fold_level` :246, `_pallas_fold_halving` :326, `_pallas_fold_grid` :589 |
| `g1_add_chain`, `fq_mul_chain`, `fq_sqr_chain` | `svt_g1_add_chain`, `svt_fq_mul_chain` (fold_kernels.cu) | the probe `benchmarks/micro_packed_dissect.py` :48 |
| `msm_windowed` | `svt_msm_windowed` (msm_loops.cu) | `ec/curve.py::CurveOps.msm_windowed` :194 with `tree_sum` :245 (XLA) |

Each wrapper checks device, dtype, shape, contiguity and alignment.  For a
CUDA tensor it launches its kernel on the current stream, into an output
from `torch.empty`, raises if the launch is refused, and adds one to its
entry in `LAUNCHES`.  Only for a CPU tensor does it run its plain twin
(`*_plain`, the same function in plain PyTorch): there is no fallback.
The source notes in csrc/ give each kernel's bound and what its design
does about it.

Drivers over the wrappers: the dense bucket-fold level walks
(`fold_buckets_chunked`, `fold_buckets_halving`, `fold_buckets_grid_dense`,
as `pallas_ops.py:260-283, 602-648`) and `to_affine` (`ec/curve.py:261`).
The verify MSM's plain version, `msm_windowed_plain` with `tree_sum`, is the
JAX package's loop of group operations; on the card no loop launches
`svt_g1_add` or `svt_g1_double` any more.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .._launch import LAUNCHES, check as _check, launch as _launch, reset_launches
from .._launch import same_device as _same_device
from ..ec.g1 import G1, limbs_to_words, words_to_limbs
from ..ff import FQ_FIELD, FQW, digits4


# ---------------------------------------------------------------- add / double


def add_plain(a, b):
    """RC15 complete add in plain PyTorch (ec/curve.py)."""
    return limbs_to_words(G1.add(words_to_limbs(a), words_to_limbs(b)))


def double_plain(a):
    """RC15 complete doubling in plain PyTorch (ec/curve.py)."""
    return limbs_to_words(G1.double(words_to_limbs(a)))


def add(a, b):
    """(B,3,8) + (B,3,8) -> (B,3,8): one thread per pair."""
    _check("add", a, 3, (3, 8))
    _check("add", b, 3, (3, 8))
    _same_device("add", a, b)
    if a.shape != b.shape:
        raise ValueError(f"add: shapes differ {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device.type == "cpu":
        return add_plain(a, b)
    out = torch.empty_like(a)
    if a.shape[0]:
        lib = load_library()
        _launch("add", lib.svt_g1_add, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                a.shape[0], device=a.device)
    return out


def double(a):
    """(B,3,8) -> (B,3,8): one thread per point."""
    _check("double", a, 3, (3, 8))
    if a.device.type == "cpu":
        return double_plain(a)
    out = torch.empty_like(a)
    if a.shape[0]:
        lib = load_library()
        _launch("double", lib.svt_g1_double, a.data_ptr(), out.data_ptr(), a.shape[0],
                device=a.device)
    return out


# ---------------------------------------------------------------- bucket fold


def fold_buckets_plain(points_ext, idx):
    """Gather + halving tree fold in plain PyTorch: the JAX package's
    `_bucket_accumulate` / `_tree_fold_flat` (pippenger.py:190-214).  Row n
    of points_ext must be the identity; it is what the sentinel gathers.
    Trailing columns that hold only sentinels add nothing and are cut."""
    nb = idx.shape[0]
    sentinel = points_ext.shape[0] - 1
    live = torch.nonzero((idx != sentinel).any(0))
    width = int(live[-1]) + 1 if live.numel() else 0
    if width == 0:
        return limbs_to_words(G1.infinity((nb,), device=idx.device))
    mat = words_to_limbs(points_ext)[idx[:, :width].long()]  # (nb, width, 3, 16)
    while width > 1:
        half = width // 2
        summed = G1.add(mat[:, :half], mat[:, half : 2 * half])
        mat = torch.cat([summed, mat[:, 2 * half : width]], dim=1)
        width = mat.shape[1]
    return limbs_to_words(mat[:, 0])


# Fold blocks (128 threads) resident on one SM: csrc/msm_kernels.cu bounds the
# kernel's registers for this many (FOLD_BLOCKS_PER_SM there).
_FOLD_BLOCKS_PER_SM = 3
# `fold_buckets_split` cuts long rows into as many segments as keep the
# launch within this many rows: one resident wave of 128-thread teams on a
# card of 128 SMs or more.
SPLIT_ROWS = 128 * _FOLD_BLOCKS_PER_SM


def _fold_team(nb: int, device) -> int:
    """Threads per bucket row: the largest team (128, 64) whose blocks are
    all resident at once, so a launch of few rows still fills the card;
    one warp per row when rows alone fill it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave_threads = 128 * _FOLD_BLOCKS_PER_SM * sms
    for team in (128, 64):
        if nb * team <= wave_threads:
            return team
    return 32


def fold_buckets(points_ext, idx):
    """Bucket sums: points_ext (n+1, 3, 8) with the identity at row n, idx
    (nb, cap) int32 point indices with n as the empty-slot sentinel ->
    (nb, 3, 8).  The gather is fused into the kernel; nb may stack the
    rows of many windows (one launch folds them all)."""
    _check("fold_buckets", points_ext, 3, (3, 8))
    _check("fold_buckets", idx, 2)
    _same_device("fold_buckets", points_ext, idx)
    if points_ext.shape[0] < 1:
        raise ValueError("fold_buckets: points_ext needs the identity row")
    if idx.device.type == "cpu":
        return fold_buckets_plain(points_ext, idx)
    nb, cap = idx.shape
    sentinel = points_ext.shape[0] - 1
    if sentinel >= 1 << 31:
        raise ValueError("fold_buckets: more points than int32 indices reach")
    out = torch.empty((nb, 3, 8), dtype=torch.int32, device=idx.device)
    if nb:
        lib = load_library()
        _launch("fold_buckets", lib.svt_fold_buckets, points_ext.data_ptr(), idx.data_ptr(),
                nb, cap, sentinel, out.data_ptr(), _fold_team(nb, idx.device), device=idx.device)
    return out


def fold_buckets_split(points_ext, idx):
    """`fold_buckets` for a few long rows (the MSM's top window): each row
    is cut into S equal segments, padded with the sentinel, S the most
    that keeps the (nb·S, cap/S) launch within SPLIT_ROWS rows; `fold_level`
    then sums each row's S partial sums.  The same reshapes on every device."""
    _check("fold_buckets_split", idx, 2)
    nb, cap = idx.shape
    if nb == 0 or cap == 0:
        return fold_buckets(points_ext, idx)
    segs = max(1, min(SPLIT_ROWS // nb, cap))
    seg_len = -(-cap // segs)
    pad = segs * seg_len - cap
    if pad:
        sentinel = points_ext.shape[0] - 1
        idx = torch.cat([idx, idx.new_full((nb, pad), sentinel)], dim=1)
    parts = fold_buckets(points_ext, idx.view(nb * segs, seg_len))
    return fold_level(parts.view(nb, segs, 3, 8), segs)[:, 0]


def identity(batch_shape, device):
    """(0 : 1 : 0) in words, broadcast to `batch_shape` (a view)."""
    return limbs_to_words(G1.infinity((), device=device)).expand(*batch_shape, 3, 8)


# ---------------------------------------------------------- dense bucket folds


def fold_segments_plain(mat, G: int, CW: int, S: int, count: int):
    """out[b, j] = Σ_{k<count} mat[b, (j // G)·CW + (j % G) + k·S] in plain
    PyTorch, summed as the kernel sums it: a chain over k."""
    nb, w = mat.shape[:2]
    j = torch.arange(w // count, device=mat.device)
    first = (j // G) * CW + (j % G)
    pts = words_to_limbs(mat)
    acc = pts[:, first]
    for k in range(1, count):
        acc = G1.add(acc, pts[:, first + k * S])
    return limbs_to_words(acc)


def fold_segments(mat, G: int, CW: int, S: int, count: int):
    """Partial fold of a dense bucket matrix: (NB, w, 3, 8) -> (NB, w/count,
    3, 8), output slot j summing the `count` slots (j // G)·CW + (j % G) +
    k·S.  The callers below give the slot groupings of the Pallas folds."""
    _check("fold_segments", mat, 4, (3, 8))
    nb, w = mat.shape[:2]
    if min(G, CW, S, count) < 1 or w % count:
        raise ValueError(f"fold_segments: bad grouping G={G} CW={CW} S={S} count={count} "
                         f"for width {w}")
    wout = w // count
    q, r = divmod(wout - 1, G)  # the farthest first slot: last q's r, or r = G-1 of q-1
    last = max(q * CW + r, (q - 1) * CW + G - 1)
    if wout and last + (count - 1) * S >= w:
        raise ValueError(f"fold_segments: grouping reads past width {w}")
    if mat.device.type == "cpu":
        return fold_segments_plain(mat, G, CW, S, count)
    out = torch.empty((nb, wout, 3, 8), dtype=torch.int32, device=mat.device)
    if nb * wout:
        _launch("fold_segments", load_library().svt_fold_segments, mat.data_ptr(), nb, w, wout,
                G, CW, S, count, out.data_ptr(), device=mat.device)
    return out


def fold_level(mat, K: int):
    """One K-way level of adjacent slots: (NB, w) -> (NB, w/K), the slot
    subsets of `_pallas_fold_level` (pallas_ops.py:237)."""
    return fold_segments(mat, 1, K, 1, K)


def fold_halving(mat, layers: int):
    """`layers` halving layers across the whole width: (NB, w) -> (NB,
    w >> layers), slot j summing j + k·g (g = w >> layers, k < 2^layers),
    the slot subsets of `_pallas_fold_halving` (pallas_ops.py:316)."""
    w = mat.shape[1]
    g = w >> layers
    if g << layers != w:
        raise ValueError(f"fold_halving: width {w} is not a multiple of 2^{layers}")
    return fold_segments(mat, g, w, g, 1 << layers)


def fold_grid(mat, wb: int, layers: int):
    """The same halving inside each wb-wide chunk: (NB, w) -> (NB,
    (w/wb)·(wb >> layers)), the slot subsets of `_pallas_fold_grid`
    (pallas_ops.py:573) and its 2-D twin `_pallas_fold_grid2d` (:553)."""
    w = mat.shape[1]
    g = wb >> layers
    if w % wb or g << layers != wb:
        raise ValueError(f"fold_grid: width {w} / chunk {wb} / {layers} layers do not tile")
    return fold_segments(mat, g, wb, g, 1 << layers)


def _pad_identity(mat, pad: int):
    if not pad:
        return mat
    fill = identity((mat.shape[0], pad), mat.device)
    return torch.cat([mat, fill], dim=1)


def _check_dense(name, mat):
    _check(name, mat, 4, (3, 8))
    if mat.shape[1] < 1:
        raise ValueError(f"{name}: empty bucket matrix")


def fold_buckets_chunked(mat, K: int = 8, on_level=None):
    """(NB, cap, 3, 8) dense bucket matrix -> (NB, 3, 8) bucket sums by K-way
    levels, each width padded with identities to a multiple of K
    (pallas_ops.py::fold_buckets_chunked :260).  `on_level`, if given, is
    called with each level's output (chip_smoke.py times the levels)."""
    if K < 2 or K & (K - 1):
        raise ValueError(f"fold_buckets_chunked: K={K} must be a power of two")
    _check_dense("fold_buckets_chunked", mat)
    w = mat.shape[1]
    while w > 1:
        mat = _pad_identity(mat, (-w) % K)
        mat = fold_level(mat, K)
        w = mat.shape[1]
        if on_level:
            on_level(mat)
    return mat[:, 0]


def fold_buckets_halving(mat, layers_per_call: int = 4, on_level=None):
    """Dense bucket sums by chained halving calls, `layers_per_call` layers
    each (pallas_ops.py::fold_buckets_halving :631)."""
    _check_dense("fold_buckets_halving", mat)
    w = mat.shape[1]
    while w > 1:
        layers = min(layers_per_call, (w - 1).bit_length())
        mat = _pad_identity(mat, (-w) % (1 << layers))
        mat = fold_halving(mat, layers)
        w = mat.shape[1]
        if on_level:
            on_level(mat)
    return mat[:, 0]


def fold_buckets_grid_dense(mat, wb: int = 512, layers: int = 4, on_level=None):
    """Dense bucket sums by the fixed-chunk grid walk of
    pallas_ops.py::fold_buckets_grid (:602): widths >= wb fold `layers`
    layers per wb-chunk, the tail folds its whole width."""
    _check_dense("fold_buckets_grid_dense", mat)
    w = mat.shape[1]
    while w > 1:
        if w >= wb:
            mat = _pad_identity(mat, (-w) % wb)
            mat = fold_grid(mat, wb, layers)
        else:
            lyr = min(layers, (w - 1).bit_length())
            mat = _pad_identity(mat, (-w) % (1 << lyr))
            mat = fold_grid(mat, mat.shape[1], lyr)
        w = mat.shape[1]
        if on_level:
            on_level(mat)
    return mat[:, 0]


# ------------------------------------------------------------ the chain probe


def g1_add_chain_plain(a, b, ch: int):
    """ch steps of a <- a + b in plain PyTorch."""
    for _ in range(ch):
        a = add_plain(a, b)
    return a


def g1_add_chain(a, b, ch: int):
    """(B,3,8), (B,3,8) -> a + ch·b as ch chained RC15 adds per lane, with
    both operands in registers."""
    _check("g1_add_chain", a, 3, (3, 8))
    _check("g1_add_chain", b, 3, (3, 8))
    _same_device("g1_add_chain", a, b)
    if a.shape != b.shape or ch < 0:
        raise ValueError("g1_add_chain: shapes differ or ch < 0")
    if a.device.type == "cpu":
        return g1_add_chain_plain(a, b, ch)
    out = torch.empty_like(a)
    if a.shape[0]:
        _launch("g1_add_chain", load_library().svt_g1_add_chain, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], ch, device=a.device)
    return out


def fq_mul_chain_plain(a, b, ch: int):
    """ch steps of a <- a·b (Fq Montgomery) in plain PyTorch."""
    x, y = words_to_limbs(a), words_to_limbs(b)
    for _ in range(ch):
        x = FQ_FIELD.mul(x, y)
    return limbs_to_words(x)


def fq_mul_chain(a, b, ch: int):
    """(B,8), (B,8) Fq words -> ch chained Montgomery multiplies per lane."""
    _check("fq_mul_chain", a, 2, (8,))
    _check("fq_mul_chain", b, 2, (8,))
    _same_device("fq_mul_chain", a, b)
    if a.shape != b.shape or ch < 0:
        raise ValueError("fq_mul_chain: shapes differ or ch < 0")
    if a.device.type == "cpu":
        return fq_mul_chain_plain(a, b, ch)
    out = torch.empty_like(a)
    if a.shape[0]:
        _launch("fq_mul_chain", load_library().svt_fq_mul_chain, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], ch, device=a.device)
    return out


def fq_sqr_chain_plain(a, ch: int):
    """ch steps of a <- a·a (Fq Montgomery) in plain PyTorch."""
    x = words_to_limbs(a)
    for _ in range(ch):
        x = FQ_FIELD.mul(x, x)
    return limbs_to_words(x)


def fq_sqr_chain(a, ch: int):
    """(B,8) Fq words -> ch chained Montgomery squarings per lane: the same
    kernel as `fq_mul_chain`, stepping through the dedicated square
    (csrc/fq.cuh::fe_sqr)."""
    _check("fq_sqr_chain", a, 2, (8,))
    if ch < 0:
        raise ValueError("fq_sqr_chain: ch < 0")
    if a.device.type == "cpu":
        return fq_sqr_chain_plain(a, ch)
    out = torch.empty_like(a)
    if a.shape[0]:
        _launch("fq_mul_chain", load_library().svt_fq_mul_chain, a.data_ptr(), None,
                out.data_ptr(), a.shape[0], ch, device=a.device)
    return out


# ------------------------------------------------------------ verify-path MSM


def tree_sum(pts, dim: int = 0):
    """Sum (..., 3, 8) points along batch axis `dim` by halving folds (an
    odd width carries its last point up), in plain PyTorch."""
    pts = pts.movedim(dim, 0)
    while pts.shape[0] > 1:
        half = pts.shape[0] // 2
        summed = add_plain(pts[:half], pts[half : 2 * half])
        pts = torch.cat([summed, pts[2 * half :]], 0)
    return pts[0]


def msm_windowed_plain(pts, digits, c: int = 4):
    """Σ_i digits-scalar_i · pts_i with shared doublings, in plain PyTorch:
    pts (..., n, 3, 8), digits (..., n, nw) c-bit windows LSB first ->
    (..., 3, 8).  The table T[d] = d·P_i (d < 2^c) takes 2^c - 2 adds; each
    window, MSB first, c doublings, one gather and a tree sum over the n
    bases (ec/curve.py::CurveOps.msm_windowed)."""
    n_axis = pts.dim() - 3
    batch = pts.shape[:n_axis]
    inf = identity(pts.shape[:-2], pts.device)
    tab, acc = [inf, pts], pts
    for _ in range(2**c - 2):
        acc = add_plain(acc, pts)
        tab.append(acc)
    tab = torch.stack(tab, dim=n_axis + 1)  # (..., n, 2^c, 3, 8)
    acc = identity(batch, pts.device)
    for w in range(digits.shape[-1] - 1, -1, -1):
        for _ in range(c):
            acc = double_plain(acc)
        idx = digits[..., w].to(torch.int64)[..., None, None, None]
        sel = torch.take_along_dim(tab, idx, dim=n_axis + 1).squeeze(n_axis + 1)
        acc = add_plain(acc, tree_sum(sel, dim=n_axis))
    return acc


def msm_windowed(pts, scalars, c: int = 4):
    """Σ_i scalar_i · pts_i for each proof: pts (B, n, 3, 8) projective
    words, scalars (B, n, 8) canonical Fr words -> (B, 3, 8), over the 64
    windows of 4 bits of `ff.digits4`.  On the card one launch of
    `svt_msm_windowed` (csrc/msm_loops.cu); on the CPU `msm_windowed_plain`.
    Only c = 4, the verify path's window, is taken."""
    if c != 4:
        raise ValueError(f"msm_windowed: c={c}; the kernel reads 4-bit windows only")
    _check("msm_windowed", pts, 4, (3, 8))
    _check("msm_windowed", scalars, 3, (8,))
    _same_device("msm_windowed", pts, scalars)
    if pts.shape[:2] != scalars.shape[:2]:
        raise ValueError(f"msm_windowed: {tuple(pts.shape[:2])} bases but "
                         f"{tuple(scalars.shape[:2])} scalars")
    if pts.device.type == "cpu":
        return msm_windowed_plain(pts, digits4(scalars), c)
    B, n = pts.shape[:2]
    if n >= 1 << 31:
        raise ValueError("msm_windowed: more bases than an int32 counts")
    out = torch.empty((B, 3, 8), dtype=torch.int32, device=pts.device)
    if B:
        _launch("msm_windowed", load_library().svt_msm_windowed, pts.data_ptr(),
                scalars.data_ptr(), B, n, out.data_ptr(), device=pts.device)
    return out


def to_affine(pt):
    """(..., 3, 8) -> (x, y, is_inf), x and y Fq Montgomery words (the
    identity maps to (0, 0))."""
    x, y, z = pt[..., 0, :], pt[..., 1, :], pt[..., 2, :]
    zinv = FQW.inv(z)
    xy = FQW.mul(torch.stack([x, y], -2), zinv[..., None, :])
    return xy[..., 0, :], xy[..., 1, :], FQW.is_zero(z)
