"""Pippenger multi-scalar multiplication on the GPU: the counterpart of the
JAX package's `msm/pippenger.py`.

Same window/bucket semantics and the same static shapes:

  1. slot assignment (`_slot_indices`, plain torch on the device): c-bit
     digits -> a (buckets, capacity) matrix of point indices per window,
     with n as the empty-slot sentinel and an overflow flag;
  2. bucket sums (`bucket_sums`): the fused gather + fold kernel
     (`cuda_ops.fold_buckets`), one launch for the rows of all main windows;
     the top window keeps its own (top_range, top_capacity) matrix, as in
     the JAX package (pippenger.py:307-311), whose few long rows are split
     into segments, folded, and their partial sums folded again;
  3. Σ_w 2^(c·w) Σ_b b·B_{w,b} (`bucket_reduce`): the weighted bucket sums
     and the window combine in one launch of `svt_bucket_reduce`, a block
     of 32 teams a window (csrc/msm_loops.cuh); its plain version is the
     JAX package's suffix scan, tree sum and Horner loop.

The JAX package's `msm_rns` (the RNS layout for the TPU's int8 matrix unit)
has no separate counterpart: on the GPU `msm` does its job.  The port needs
no padding of n to a ranking block: its ranking is a stable sort.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._build import load_library
from .._launch import check as _check, launch as _launch
from ..device import resolve_device
from ..ec.g1 import G1, limbs_to_words, words_to_limbs
from ..ff.spec import FR
from . import cuda_ops

C_BITS = 8  # default window size
SCALAR_BITS = 256


def n_windows(c: int) -> int:
    return (SCALAR_BITS + c - 1) // c


def default_capacity(n: int, n_buckets: int = 1 << C_BITS) -> int:
    """Static per-bucket capacity: mean + 8*sqrt(mean) + 16 (bucket loads of
    uniform digits are ~Poisson(mean)); `msm` flags an overflow."""
    mean = max(1, n // n_buckets)
    return min(n, int(mean + 8 * mean**0.5 + 16))


def top_range(c: int) -> int:
    """Digit range of the most-significant window: r < 2^254 concentrates
    the top digits ([0, 48] for c=8)."""
    return (FR.p >> (c * (n_windows(c) - 1))) + 1


def top_capacity(n: int, c: int) -> int:
    """Capacity for the top window, covering uniform-mod-r scalars and
    `uniform 256-bit mod r` sampling (see the JAX package's top_capacity)."""
    shift = c * (n_windows(c) - 1)
    wraps = -(-(1 << 256) // FR.p)  # ceil
    mean = max(1, n * wraps * (1 << shift) >> 256)
    return min(n, int(mean + 8 * mean**0.5 + 16))


def extract_digits(scalars_u16, c: int):
    """(n,16) canonical 16-bit limbs -> (W, n) int64 c-bit digits."""
    s = scalars_u16.to(torch.int64)
    padded = torch.cat([s, s.new_zeros(s.shape[0], 1)], dim=1)
    outs = []
    for w in range(n_windows(c)):
        bit0 = w * c
        l, off = bit0 // 16, bit0 % 16
        lo = padded[:, l] >> off
        if off + c > 16:
            lo = lo | (padded[:, l + 1] << (16 - off))
        outs.append(lo & ((1 << c) - 1))
    return torch.stack(outs, 0)


def scalars_from_int(ints):
    """Host: python-int scalars -> (n,16) int64 canonical 16-bit limbs (CPU)."""
    raw = b"".join((int(s) % FR.p).to_bytes(32, "little") for s in ints)
    arr = np.frombuffer(raw, dtype="<u2").reshape(-1, 16)
    return torch.from_numpy(arr.astype(np.int64))


def _slot_indices(digits, n_buckets: int, capacity: int):
    """Batched slot assignment for a stack of windows, the same output as
    the JAX package's `_slot_indices` (pippenger.py:240-273).

    digits: (W, n).  Returns (idx (W, n_buckets, capacity) int32 with n as
    the sentinel, overflow bool tensor).  A stable sort by digit plus bucket
    starts from the digit counts gives each point its rank in its bucket in
    index order, as the JAX package's one-hot ranking does."""
    W, n = digits.shape
    dev = digits.device
    d = digits.to(torch.int64)
    sorted_d, perm = torch.sort(d, dim=1, stable=True)
    counts = torch.zeros(W, n_buckets, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, d, torch.ones_like(d))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(n, device=dev) - starts.gather(1, sorted_d)
    overflow = (counts[:, 1:] > capacity).any()
    # digit-0 entries have weight zero and overflowing ranks are dropped:
    # both go to the extra slot `capacity` of their bucket, cut off below.
    tgt = torch.where(sorted_d == 0, capacity, rank.clamp(max=capacity))
    row = sorted_d + n_buckets * torch.arange(W, device=dev).unsqueeze(1)
    flat = (row * (capacity + 1) + tgt).reshape(-1)
    idx = torch.full((W * n_buckets * (capacity + 1),), n, dtype=torch.int32, device=dev)
    idx[flat] = perm.reshape(-1).to(torch.int32)  # repeated targets: dropped slots only
    idx = idx.view(W, n_buckets, capacity + 1)[:, :, :capacity]
    return idx.contiguous(), overflow


def _identity(k: int, device):
    return limbs_to_words(G1.infinity((k,), device=device))


def _weighted_bucket_sum(buckets):
    """Σ_{b>=1} b·B_b over axis 1 of (W, n_buckets, 3, 8) in plain PyTorch,
    as the tree sum of suffix sums: a Hillis-Steele scan (log2 steps) then
    a halving tree, each step batched over every window."""
    add = cuda_ops.add_plain
    s = buckets[:, 1:].flip(1)  # B_max ... B_1
    width = s.shape[1]
    d = 1
    while d < width:
        s = torch.cat([s[:, :d], add(s[:, d:], s[:, : width - d])], dim=1)
        d *= 2
    while s.shape[1] > 1:  # tree sum, odd widths carry their last column
        half = s.shape[1] // 2
        s = torch.cat([add(s[:, :half], s[:, half : 2 * half]), s[:, 2 * half :]], dim=1)
    return s[:, 0]


def _horner(wsums, c: int):
    """Combine window sums MSB-first in plain PyTorch: acc = 2^c·acc + wsum.
    (W,3,8) -> (1,3,8)."""
    acc = _identity(1, wsums.device)
    for w in range(wsums.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = cuda_ops.double_plain(acc)
        acc = cuda_ops.add_plain(acc, wsums[w : w + 1])
    return acc


def bucket_reduce_plain(buckets, c: int):
    """Σ_w 2^(c·w) Σ_{b>=1} b·B_{w,b} in plain PyTorch: the weighted sums,
    then Horner."""
    return _horner(_weighted_bucket_sum(buckets), c)


def bucket_reduce(buckets, c: int = C_BITS):
    """Every window's bucket sums (W, 2^c, 3, 8) -> (1, 3, 8) =
    Σ_w 2^(c·w) Σ_{b>=1} b·B_{w,b}.  On the card one launch of
    `svt_bucket_reduce` (csrc/msm_loops.cuh), which takes c = 8 only; on the
    CPU `bucket_reduce_plain`."""
    _check("bucket_reduce", buckets, 4, (3, 8))
    if tuple(buckets.shape[:2]) != (n_windows(c), 1 << c):
        raise ValueError(f"bucket_reduce: {tuple(buckets.shape[:2])} buckets for c={c}")
    if buckets.device.type == "cpu":
        return bucket_reduce_plain(buckets, c)
    if c != 8:
        raise ValueError(f"bucket_reduce: c={c}; the kernel reduces 8-bit windows only")
    # the kernel's scratch: one point per window, then its ticket word
    part = torch.empty(n_windows(c) * 24 + 1, dtype=torch.int32, device=buckets.device)
    out = torch.empty((1, 3, 8), dtype=torch.int32, device=buckets.device)
    _launch("bucket_reduce", load_library().svt_bucket_reduce, buckets.data_ptr(),
            part.data_ptr(), out.data_ptr(), device=buckets.device)
    return out


def bucket_sums(points_ext, idx_all, top_idx):
    """Every window's bucket sums, (W, n_buckets, 3, 8): all main windows'
    rows idx_all (W-1, n_buckets, cap) in one fold launch; the top window's
    few long rows top_idx (trange, tcap) split into segments and folded
    twice.  The top window's trange buckets are padded with identities to
    n_buckets, so it joins the others in one batched weighted sum."""
    n_main, n_buckets, cap = idx_all.shape
    main = cuda_ops.fold_buckets(points_ext, idx_all.view(n_main * n_buckets, cap))
    top = cuda_ops.fold_buckets_split(points_ext, top_idx)
    fill = _identity(n_buckets - top.shape[0], top.device)
    return torch.cat([main, top, fill], dim=0).view(n_main + 1, n_buckets, 3, 8)


def _as_limbs(x, name: str, tail: tuple, device):
    """numpy (the JAX package's uint32 arrays) or tensor -> int64 on device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a numpy array or a tensor")
    if x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail:
        raise ValueError(f"{name}: expected shape (n, {', '.join(map(str, tail))}), "
                         f"got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int64)


def msm(points, scalars_u16, capacity: Optional[int] = None, c: int = C_BITS, device=None):
    """Σ sᵢ·Pᵢ.  points: (n,3,16) projective Montgomery limbs (the JAX
    package's layout; numpy or tensor); scalars_u16: (n,16) canonical 16-bit
    limbs (`scalars_from_int`).  device None means the CUDA card.

    Returns (result (3,16) int64 limbs on the device, overflow bool tensor):
    a set flag means a bucket held more than `capacity` points and the
    result is wrong; `msm_checked` retries."""
    dev = resolve_device(device)
    pts = _as_limbs(points, "points", (3, 16), dev)
    sc = _as_limbs(scalars_u16, "scalars_u16", (16,), dev)
    n = pts.shape[0]
    if sc.shape[0] != n:
        raise ValueError(f"msm: {n} points but {sc.shape[0]} scalars")
    if n == 0:
        return G1.infinity(device=dev), torch.zeros((), dtype=torch.bool, device=dev)
    n_buckets = 1 << c
    if capacity is None:
        capacity = default_capacity(n, n_buckets)
    points_ext = torch.cat([limbs_to_words(pts), _identity(1, dev)], dim=0)

    digits = extract_digits(sc, c)  # (W, n)
    trange = top_range(c)
    if int(digits[-1].max()) >= trange:
        raise ValueError("msm: scalars must be canonical (< r)")
    idx_all, overflow = _slot_indices(digits[:-1], n_buckets, capacity)
    tcap = max(capacity, top_capacity(n, c))
    top_idx, top_o = _slot_indices(digits[-1:], trange, tcap)

    buckets = bucket_sums(points_ext, idx_all, top_idx[0])
    acc = bucket_reduce(buckets, c)
    return words_to_limbs(acc[0]), overflow | top_o


def msm_checked(points, scalars_u16, capacity: Optional[int] = None, c: int = C_BITS,
                device=None):
    """`msm`, growing capacity on bucket overflow until the result is exact
    (adversarial scalar distributions), as in the JAX package."""
    n = points.shape[0]
    cap = capacity or default_capacity(n, 1 << c)
    while True:
        out, ovf = msm(points, scalars_u16, capacity=cap, c=c, device=device)
        if not bool(ovf):
            return out
        if cap >= max(n, 8):
            return out  # capacity covers every point; overflow impossible
        cap = min(max(n, 8), cap * 4)


def msm_int(bases, tables: dict, scalars, device=None):
    """Σ sᵢ·basesᵢ over the first len(scalars) of `bases` (affine int
    tuples) with python-int scalars -> an affine tuple of python ints, None
    for the identity: a host prover's commitment.

    device None means the CUDA card: one `msm_checked` over the bases' (N, 3,
    16) limbs, converted and uploaded once per device into `tables` (keyed
    by `device_key`), with the canonical scalars of `scalars_from_int`.  An
    explicit "cpu" runs the python-int `py_ec.msm`.  Nothing falls back from
    the card to the CPU: a missing card raises, as `resolve_device` does."""
    from ..device import device_key
    from ..ec import py_ec
    from ..ec.g1 import from_affine_int, to_affine_int

    dev = resolve_device(device)
    n = len(scalars)
    if n > len(bases):
        raise ValueError(f"msm_int: {n} scalars for {len(bases)} bases")
    scalars = [int(s) % FR.p for s in scalars]
    if dev.type == "cpu":
        return py_ec.msm(bases[:n], scalars)
    key = device_key(dev)
    if key not in tables:
        tables[key] = from_affine_int(list(bases), device=dev)
    if n == 0:
        return None
    out = msm_checked(tables[key][:n], scalars_from_int(scalars), device=dev)
    return to_affine_int(out)
