"""BN254 G1 points made on the device in plain torch, for the MSM cell's
bases: the benchmark's own code, none of the program's kernels.

Fq elements are (..., 16) int64 tensors of 16-bit limbs holding the
Montgomery form x·R mod p (R = 2^256), canonical: the layout the program's
`msm` takes for the coordinates of its (n, 3, 16) homogeneous projective
points.  `mont_mul`, `add` and `sub` work limb-serially (16 steps of a few
vector ops each), which is slow per element and fast over millions of lanes
at once."""

from __future__ import annotations

import torch

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 1 << 256
LIMBS, BITS, MASK = 16, 16, 0xFFFF
NINV = (-pow(P, -1, 1 << BITS)) % (1 << BITS)  # -p^-1 mod 2^16


def int_to_limbs(x: int):
    return [(x >> (BITS * i)) & MASK for i in range(LIMBS)]


def limbs_to_int(row) -> int:
    return sum(int(v) << (BITS * i) for i, v in enumerate(row))


def to_mont_limbs(values, device):
    """python ints -> (len, 16) int64 Montgomery limbs on `device`."""
    return torch.tensor([int_to_limbs(v * R % P) for v in values], dtype=torch.int64,
                        device=device)


def from_mont_int(row) -> int:
    return limbs_to_int(row) * pow(R, -1, P) % P


def _p_limbs(device):
    return torch.tensor(int_to_limbs(P), dtype=torch.int64, device=device)


def _normalize(t):
    """Propagate carries through (..., k) limbs in place; returns the carry
    out of the top limb."""
    carry = torch.zeros_like(t[..., 0])
    for i in range(t.shape[-1]):
        v = t[..., i] + carry
        t[..., i] = v & MASK
        carry = v >> BITS
    return carry


def _reduce_once(t, top):
    """(..., 16) normalized limbs with carry `top` (value < 2p) -> < p."""
    p = _p_limbs(t.device)
    d = t - p
    borrow = torch.zeros_like(t[..., 0])
    for i in range(LIMBS):
        v = d[..., i] - borrow
        d[..., i] = v & MASK
        borrow = (v < 0).to(torch.int64)
    keep = (borrow > top).unsqueeze(-1)  # t < p: the subtraction borrowed past the top
    return torch.where(keep, t, d)


def add(a, b):
    t = a + b
    return _reduce_once(t, _normalize(t))


def sub(a, b):
    t = a - b + _p_limbs(a.device)
    # limbs may be negative: a signed carry (arithmetic shift) normalizes them
    return _reduce_once(t, _normalize(t))


def mont_mul(a, b):
    """a·b·R^-1 mod p, canonical, over broadcast (..., 16) limbs."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(*shape[:-1], LIMBS * LIMBS)
    col = (torch.arange(LIMBS, device=a.device).unsqueeze(1)
           + torch.arange(LIMBS, device=a.device).unsqueeze(0)).reshape(-1)
    t = torch.zeros(*shape[:-1], 2 * LIMBS + 1, dtype=torch.int64, device=a.device)
    t.index_add_(-1, col, prod)  # column sums < 16 · 2^32
    p = _p_limbs(a.device)
    for i in range(LIMBS):
        m = ((t[..., i] & MASK) * NINV) & MASK
        t[..., i : i + LIMBS] += m.unsqueeze(-1) * p
        t[..., i + 1] += t[..., i] >> BITS
        t[..., i] = 0
    hi = t[..., LIMBS:].clone()
    top = _normalize(hi)
    return _reduce_once(hi[..., :LIMBS], hi[..., LIMBS] + top)


def add_affine_pairs(x1, y1, x2, y2):
    """(x1, y1) + (x2, y2) for affine points with x1 ≠ x2 on every lane, as
    homogeneous projective (X : Y : Z) Montgomery limbs: with u = y2 − y1,
    v = x2 − x1, X = v·(u² − v²·(x1 + x2)), Y = u·(v²·(2·x1 + x2) − u²) −
    y1·v³, Z = v³."""
    u, v = sub(y2, y1), sub(x2, x1)
    uu, vv = mont_mul(u, u), mont_mul(v, v)
    vvv = mont_mul(vv, v)
    X = mont_mul(v, sub(uu, mont_mul(vv, add(x1, x2))))
    Y = sub(mont_mul(u, sub(mont_mul(vv, add(add(x1, x1), x2)), uu)), mont_mul(y1, vvv))
    return X, Y, vvv
