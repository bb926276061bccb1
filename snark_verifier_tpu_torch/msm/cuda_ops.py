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
| `msm_windowed` | `svt_msm_windowed` (msm_loops.cuh) | `ec/curve.py::CurveOps.msm_windowed` :194 with `tree_sum` :245 (XLA) |
| `h_coeffs` | `svt_ipa_h_coeffs` (ipa_kernels.cu) | `pcs/ipa/ipa.py::h_coeffs_dev` :95 and decide's `to_repr_u16` :346 (XLA) |

Each wrapper checks device, dtype, shape, contiguity and alignment.  For a
CUDA tensor it launches its kernel on the current stream, into an output
from `torch.empty`, raises if the launch is refused, and adds one to its
entry in `LAUNCHES`.  Only for a CPU tensor does it run its plain twin
(`*_plain`, the same function in plain PyTorch): there is no fallback.
The source notes in csrc/ give each kernel's bound and what its design
does about it.

Drivers over the wrappers: the dense bucket-fold level walks
(`fold_buckets_chunked`, `fold_buckets_halving`, `fold_buckets_grid_dense`,
as `pallas_ops.py:260-283, 602-648`) and `to_affine` / `affine_xy`
(`ec/curve.py:261`).
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
from ..ff import FQ_FIELD, FQW, FR_FIELD, FRW, digits4


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
# card of 132 SMs (an H100 SXM).  At the 2^20 MSM's top window (49 rows) that
# is 8 segments a row; the split measured fastest where the first pass
# fills one wave (392, 784 or 1,568 rows: 8, 16 or 32 segments with teams
# of 128, 64 or 32) and slower between them (chip_smoke.py's sweep).
SPLIT_ROWS = 132 * _FOLD_BLOCKS_PER_SM


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


def is_identity(pt):
    """(..., 3, 8) projective words -> (...) bool: Z ≡ 0 mod p, which under
    the lazy [0, 2p] contract is Z ∈ {0, p, 2p}.  Word comparisons on the
    point's device: no kernel launch, no host synchronisation."""
    zeros = torch.stack([FQW._words(v, pt.device) for v in (0, FQ_FIELD.spec.p,
                                                            2 * FQ_FIELD.spec.p)])
    return (pt[..., 2, None, :] == zeros).all(-1).any(-1)


# ---------------------------------------------------------- dense bucket folds


# Warps of independent add chains an SM needs before the multiply pipes, not
# one chain's latency, set a fold's time: a lone warp waits ~950 clocks on a
# multiply (csrc/probe/team_levels.cu), a busy SM starts one warp's multiply
# every ~144 clocks (58 G multiplies/s on 132 SMs at 1.98 GHz).
_BUSY_WARPS_PER_SM = 950 / 144
TEAMS = (1, 2, 4, 8, 16, 32)


def segment_team(n_out: int, members: int, sms: int) -> int:
    """Lanes per output slot for a `svt_fold_segments` launch of n_out slots
    of at most `members` real members each, on a card of `sms` SMs.

    A team of T lanes costs a slot ceil(members / T) - 1 + log2 T dependent
    adds, and the launch takes about that many adds' time whichever of two
    limits holds: one chain's latency while an SM has fewer than
    _BUSY_WARPS_PER_SM warps, the multiply pipes' rate beyond.  The T of
    least (dependent adds) x max(_BUSY_WARPS_PER_SM, warps per SM) wins, the
    smallest on a tie: T = 1 where the slots alone fill the card."""
    best, best_cost = 1, None
    for team in TEAMS:
        warps_per_sm = -(-n_out * team // 32) / sms
        cost = chain_adds(members, team) * max(_BUSY_WARPS_PER_SM, warps_per_sm)
        if best_cost is None or cost < best_cost:
            best, best_cost = team, cost
    return best


def chain_adds(members: int, team: int) -> int:
    """Dependent adds of a slot of `members` real members summed by a team
    of `team` lanes: the longest lane's chain, then log2 team rounds."""
    return max(-(-members // team) - 1 + team.bit_length() - 1, 0)


def grouping_team(nb: int, w: int, grouping, sms: int) -> int:
    """`segment_team` for a `fold_segments` launch of `grouping` (G, CW, S,
    count, width) over an (nb, w) matrix: slot 0 has the most real members."""
    _, _, S, count, width = grouping
    return segment_team(nb * (width // count), min(count, -(-w // S)), sms)


def _round_up(w: int, m: int) -> int:
    return -(-w // m) * m


def level_grouping(w: int, K: int):
    """(G, CW, S, count, width) of one K-way level of adjacent slots over a
    width-w matrix: the slot subsets of `_pallas_fold_level`
    (pallas_ops.py:237), the width padded to a multiple of K."""
    return 1, K, 1, K, _round_up(w, K)


def halving_grouping(w: int, layers: int):
    """`layers` halving layers across the whole (padded) width: slot j sums
    j + k·g, g = width >> layers, k < 2^layers, the slot subsets of
    `_pallas_fold_halving` (pallas_ops.py:316)."""
    width = _round_up(w, 1 << layers)
    g = width >> layers
    return g, width, g, 1 << layers, width


def grid_grouping(w: int, wb: int, layers: int):
    """The same halving inside each wb-wide chunk of the (padded) width: the
    slot subsets of `_pallas_fold_grid` (pallas_ops.py:573) and its 2-D twin
    `_pallas_fold_grid2d` (:553)."""
    g = wb >> layers
    if g < 1 or g << layers != wb:
        raise ValueError(f"fold_grid: chunk {wb} is no multiple of 2^{layers}")
    return g, wb, g, 1 << layers, _round_up(w, wb)


def fold_segments_plain(mat, G: int, CW: int, S: int, count: int, width: int | None = None):
    """out[b, j] = Σ_{k<count} mat[b, (j // G)·CW + (j % G) + k·S] in plain
    PyTorch, a chain over k; members at or past the matrix's width are
    identities and are skipped, as the kernel skips them."""
    nb, w = mat.shape[:2]
    width = _round_up(w, count) if width is None else width
    j = torch.arange(width // count, device=mat.device)
    first = (j // G) * CW + (j % G)
    pts = words_to_limbs(mat)
    acc = G1.infinity((nb, len(j)), device=mat.device)
    for k in range(count):
        idx = first + k * S
        real = (idx < w)[None, :, None, None]
        if not real.any():  # members only grow with k
            break
        p = pts[:, idx.clamp(max=w - 1)]
        acc = torch.where(real, p if k == 0 else G1.add(acc, p), acc)
    return limbs_to_words(acc)


def fold_segments(mat, G: int, CW: int, S: int, count: int, width: int | None = None, *,
                  team: int | None = None):
    """Partial fold of a dense bucket matrix: (NB, w, 3, 8) -> (NB,
    width/count, 3, 8), output slot j summing the `count` slots (j // G)·CW
    + (j % G) + k·S of the matrix read as `width` wide (by default w rounded
    up to a multiple of count): slots at or past w are identities.  The
    groupings above give the slot subsets of the Pallas folds.  `team`
    (lanes per slot, one of TEAMS) defaults to `segment_team`'s choice."""
    _check("fold_segments", mat, 4, (3, 8))
    nb, w = mat.shape[:2]
    width = _round_up(w, count) if width is None else width
    if min(G, CW, S, count) < 1 or width < w or width % count:
        raise ValueError(f"fold_segments: bad grouping G={G} CW={CW} S={S} count={count} "
                         f"for width {width} of a {w}-wide matrix")
    wout = width // count
    q, r = divmod(wout - 1, G)  # the farthest first slot: last q's r, or r = G-1 of q-1
    last = max(q * CW + r, (q - 1) * CW + G - 1)
    if wout and last + (count - 1) * S >= width:
        raise ValueError(f"fold_segments: grouping reads past width {width}")
    if team is not None and team not in TEAMS:
        raise ValueError(f"fold_segments: team {team} is not one of {TEAMS}")
    if mat.device.type == "cpu":
        return fold_segments_plain(mat, G, CW, S, count, width)
    out = torch.empty((nb, wout, 3, 8), dtype=torch.int32, device=mat.device)
    if nb * wout:
        if team is None:
            sms = torch.cuda.get_device_properties(mat.device).multi_processor_count
            team = grouping_team(nb, w, (G, CW, S, count, width), sms)
        _launch("fold_segments", load_library().svt_fold_segments, mat.data_ptr(), nb, w, wout,
                G, CW, S, count, team, out.data_ptr(), device=mat.device)
    return out


def fold_level(mat, K: int):
    """One K-way level of adjacent slots: (NB, w) -> (NB, ceil(w/K))."""
    return fold_segments(mat, *level_grouping(mat.shape[1], K))


def fold_halving(mat, layers: int):
    """`layers` halving layers across the whole width: (NB, w) -> (NB,
    ceil(w / 2^layers))."""
    return fold_segments(mat, *halving_grouping(mat.shape[1], layers))


def fold_grid(mat, wb: int, layers: int):
    """The same halving inside each wb-wide chunk: (NB, w) -> (NB,
    ceil(w/wb)·(wb >> layers))."""
    return fold_segments(mat, *grid_grouping(mat.shape[1], wb, layers))


def chunked_levels(w: int, K: int = 8):
    """The groupings of `fold_buckets_chunked`'s levels from width w: K-way
    levels until one slot is left (pallas_ops.py::fold_buckets_chunked :260,
    which pads each width with identities to a multiple of K)."""
    if K < 2 or K & (K - 1):
        raise ValueError(f"fold_buckets_chunked: K={K} must be a power of two")
    levels = []
    while w > 1:
        levels.append(level_grouping(w, K))
        w = levels[-1][4] // K
    return levels


def halving_levels(w: int, layers_per_call: int = 4):
    """`fold_buckets_halving`'s groupings: halving calls of up to
    `layers_per_call` layers (pallas_ops.py::fold_buckets_halving :631)."""
    levels = []
    while w > 1:
        levels.append(halving_grouping(w, min(layers_per_call, (w - 1).bit_length())))
        w = levels[-1][0]
    return levels


def grid_levels(w: int, wb: int = 512, layers: int = 4):
    """`fold_buckets_grid_dense`'s groupings (pallas_ops.py::fold_buckets_grid
    :602): widths >= wb fold `layers` layers per wb-chunk, the tail folds its
    whole width."""
    levels = []
    while w > 1:
        if w >= wb:
            grp = grid_grouping(w, wb, layers)
        else:
            grp = halving_grouping(w, min(layers, (w - 1).bit_length()))
        levels.append(grp)
        w = grp[4] // grp[3]
    return levels


def _walk(mat, levels, on_level):
    """One `fold_segments` launch per grouping; `on_level`, if given, is
    called with each level's output (chip_smoke.py times the levels)."""
    for grp in levels:
        mat = fold_segments(mat, *grp)
        if on_level:
            on_level(mat)
    return mat[:, 0]


def _check_dense(name, mat):
    _check(name, mat, 4, (3, 8))
    if mat.shape[1] < 1:
        raise ValueError(f"{name}: empty bucket matrix")


def fold_buckets_chunked(mat, K: int = 8, on_level=None):
    """(NB, cap, 3, 8) dense bucket matrix -> (NB, 3, 8) bucket sums by K-way
    levels (pallas_ops.py::fold_buckets_chunked :260); each level reads its
    input in place, a width that is no multiple of K as if padded with
    identities."""
    _check_dense("fold_buckets_chunked", mat)
    return _walk(mat, chunked_levels(mat.shape[1], K), on_level)


def fold_buckets_halving(mat, layers_per_call: int = 4, on_level=None):
    """Dense bucket sums by chained halving calls, `layers_per_call` layers
    each (pallas_ops.py::fold_buckets_halving :631)."""
    _check_dense("fold_buckets_halving", mat)
    return _walk(mat, halving_levels(mat.shape[1], layers_per_call), on_level)


def fold_buckets_grid_dense(mat, wb: int = 512, layers: int = 4, on_level=None):
    """Dense bucket sums by the fixed-chunk grid walk of
    pallas_ops.py::fold_buckets_grid (:602)."""
    _check_dense("fold_buckets_grid_dense", mat)
    return _walk(mat, grid_levels(mat.shape[1], wb, layers), on_level)


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


# The verify MSM's schedules (csrc/msm_loops.cuh): a ladder a lane (T = 1)
# or a team of 6 (csrc/g1_team.cuh: one product a lane and layer; teams of
# 2 and 4 measured no better, PERF.md), at most 8 warps a block.  A team of
# 6 shortens a ladder's chain (0.48 against 0.87 ms alone) but issues ~3.3x
# its instructions, so it wins only while the B n ladders leave most of the
# card's lanes idle, and only where each ladder has a team of its own (n at
# most the 40 teams of a block).  kernel_compare.py's seven shapes on an
# H100 (132 SMs, PERF.md) put the crossover between (1,024, 4), 4,096
# ladders (T = 6 0.53 ms, T = 1 0.86), and (1,024, 17), 17,408 (T = 6 1.85,
# T = 1 1.28).  MSMW_TEAM_LADDERS_PER_SM (6,336 ladders on 132 SMs) sits
# in that bracket, nearer its low end: T = 1 keeps one chain's latency
# until a scheduler holds a second warp, while a team's six lanes a ladder
# crowd the schedulers six times sooner.
MSMW_TEAMS = (1, 6)
MSMW_MAX_WARPS = 8
MSMW_TEAM_LADDERS_PER_SM = 48


def msm_windowed_geometry(n: int, team: int, per_block: int):
    """(tp, warps) of an `svt_msm_windowed` block of `per_block` proofs of
    n bases on teams of `team` lanes, as the C entry point lays it out: tp
    teams a proof (every base its own team while the block's 8 warps hold
    them, else teams loop over the bases), teams of 32 // team lanes a warp,
    back to back."""
    whole = 32 // team
    tp = min(max(n, 1), MSMW_MAX_WARPS * whole // per_block)
    return tp, -(-per_block * tp // whole)


def msm_windowed_per_block(B: int, n: int, team: int, sms: int) -> int:
    """Proofs a block: few enough that the blocks fill a card of `sms` SMs
    before any SM takes a second (or a third, ...), and whole proofs in a
    block while one base a team fits."""
    max_teams = MSMW_MAX_WARPS * (32 // team)
    k = 1
    while True:
        per_block = -(-B // (k * sms))
        if per_block * max(n, 1) <= max_teams or per_block == 1:
            return per_block
        k += 1


def msm_windowed_layout(B: int, n: int, sms: int):
    """(team, per_block) for an `svt_msm_windowed` launch of B proofs of n
    bases on a card of `sms` SMs: T = 1, one lane a ladder, where the
    ladders fill the card (the verify batch of 1,024) or outnumber a
    block's teams; a team of 6 where a few proofs leave the card idle and
    one chain's latency is the time."""
    few = B * n <= MSMW_TEAM_LADDERS_PER_SM * sms and n <= MSMW_MAX_WARPS * (32 // 6)
    team = 6 if few else 1
    return team, msm_windowed_per_block(B, n, team, sms)


def _msm_windowed_at(pts, scalars, team: int, per_block: int):
    """One `svt_msm_windowed` launch at the layout (team, per_block) on
    tensors `msm_windowed` has checked; every layout gives the same points
    (tests and kernel_compare.py force one)."""
    if team not in MSMW_TEAMS or not 1 <= per_block <= MSMW_MAX_WARPS * (32 // team):
        raise ValueError(f"msm_windowed: layout ({team}, {per_block})")
    B, n = pts.shape[:2]
    if n >= 1 << 31:
        raise ValueError("msm_windowed: more bases than an int32 counts")
    out = torch.empty((B, 3, 8), dtype=torch.int32, device=pts.device)
    if B:
        _launch("msm_windowed", load_library().svt_msm_windowed, pts.data_ptr(),
                scalars.data_ptr(), B, n, team, per_block, out.data_ptr(), device=pts.device)
    return out


def msm_windowed(pts, scalars, c: int = 4):
    """Σ_i scalar_i · pts_i for each proof: pts (B, n, 3, 8) projective
    words, scalars (B, n, 8) canonical Fr words -> (B, 3, 8).  On the card
    one launch of `svt_msm_windowed` (csrc/msm_loops.cuh: each scalar split
    by GLV, ec/glv.py, into two halves of 32 windows of 4 bits) with the
    (team, per_block) of `msm_windowed_layout`; on the CPU
    `msm_windowed_plain`.  Only c = 4, the verify path's window, is taken."""
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
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    return _msm_windowed_at(pts, scalars, *msm_windowed_layout(*pts.shape[:2], sms))


def affine_xy(pt):
    """(..., 3, 8) -> (..., 2, 8) affine (x, y), Fq Montgomery words (the
    identity maps to (0, 0)): one `svt_field_inv` and one `svt_field_mul`
    launch on the card."""
    zinv = FQW.inv(pt[..., 2, :])
    return FQW.mul(pt[..., :2, :], zinv[..., None, :])


def to_affine(pt):
    """(..., 3, 8) -> (x, y, is_inf), x and y Fq Montgomery words (the
    identity maps to (0, 0))."""
    xy = affine_xy(pt)
    return xy[..., 0, :], xy[..., 1, :], FQW.is_zero(pt[..., 2, :])


# ------------------------------------------------------ the IPA decider's h(X)


def h_coeffs_plain(xi, scalar=None):
    """The 2^k coefficients of h(X) = s·Π_i (1 + ξ_{k-1-i} X^(2^i)) in plain
    PyTorch, the JAX package's doubling (`pcs/ipa/ipa.py::h_coeffs_dev`:
    coeffs ++ coeffs·ξ over reversed ξ): xi (k, 8) Fr Montgomery words,
    scalar (8,) Montgomery words (None: 1) -> (2^k, 16) int64 canonical
    16-bit limbs, the layout `msm` reads its scalars in."""
    F = FR_FIELD
    x = words_to_limbs(xi)
    c = (F.const("ONE", xi.device) if scalar is None else words_to_limbs(scalar))[None]
    for i in range(x.shape[0] - 1, -1, -1):
        c = torch.cat([c, F.mul(c, x[i])], 0)
    one_plain = words_to_limbs(FRW.const("ONE_PLAIN", xi.device))
    return F.canon(F.mul(c, one_plain))


def h_coeffs(xi, scalar=None):
    """`h_coeffs_plain`'s function: on a CUDA tensor one launch of
    `svt_ipa_h_coeffs` (csrc/ipa_kernels.cu), on a CPU tensor the plain
    version.  The outputs are canonical, so the words are the same."""
    _check("h_coeffs", xi, 2, (8,))
    if scalar is not None:
        _check("h_coeffs", scalar, 1, (8,))
        _same_device("h_coeffs", xi, scalar)
    k = xi.shape[0]
    if k > 30:
        raise ValueError(f"h_coeffs: k = {k}; at most 2^30 coefficients")
    if xi.device.type == "cpu":
        return h_coeffs_plain(xi, scalar)
    s = FRW.const("ONE", xi.device) if scalar is None else scalar
    out = torch.empty((1 << k, 16), dtype=torch.int64, device=xi.device)
    xi_arg = xi if k else s.reshape(1, 8)  # a valid pointer for k = 0
    _launch("ipa_h_coeffs", load_library().svt_ipa_h_coeffs, xi_arg.data_ptr(), k,
            s.data_ptr(), out.data_ptr(), device=xi.device)
    return out
