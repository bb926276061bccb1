"""Pure-Python BN254 G1 (affine, python ints): a frozen copy of the port's
`ec/py_ec.py`.  Points come in and go out affine; `scalar_mul` and `msm`
work inside in Jacobian coordinates (one inversion a call), and `msm` is
Pippenger's bucket method."""

from __future__ import annotations

import random

from .fields import FQ, BN254_B

P = FQ.p


def _inv(x: int) -> int:
    return pow(x, -1, P)


# Affine points as (x, y) int tuples; None = infinity.
G1_GEN = (1, 2)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + BN254_B)) % P == 0


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return double(p1)
    lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def double(p1):
    if p1 is None:
        return None
    x1, y1 = p1
    if y1 == 0:
        return None
    lam = 3 * x1 * x1 * _inv(2 * y1) % P
    x3 = (lam * lam - 2 * x1) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def neg(p1):
    if p1 is None:
        return None
    x, y = p1
    return (x, (-y) % P)


# Jacobian (X, Y, Z) = (X/Z², Y/Z³); Z = 0 is the identity.
_JINF = (1, 1, 0)


def _jac(pt):
    return _JINF if pt is None else (pt[0], pt[1], 1)


def _jac_double(p1):
    """dbl-2009-l (a = 0)."""
    x, y, z = p1
    if z == 0 or y == 0:
        return _JINF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P


def _jac_add(p1, p2):
    """add-2007-bl, with the doubling and the inverse pair handled."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 % P * z2z2 % P
    s2 = y2 * z1 % P * z1z1 % P
    h = (u2 - u1) % P
    r = 2 * (s2 - s1) % P
    if h == 0:
        return _jac_double(p1) if r == 0 else _JINF
    i = 4 * h * h % P
    j = h * i % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P
    return x3, y3, z3


def _affine(p1):
    x, y, z = p1
    if z == 0:
        return None
    zi = _inv(z)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 % P * zi % P


def scalar_mul(p1, k: int):
    """k·p1 by double-and-add, most significant bit first."""
    base, acc = _jac(p1), _JINF
    for bit in bin(k)[2:] if k > 0 else "":
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add(acc, base)
    return _affine(acc)


def msm(points, scalars):
    """Σ sᵢ·Pᵢ (scalars taken as they are, non-negative) by Pippenger's
    buckets: c-bit windows from the top, each window's buckets summed by a
    running suffix, the windows joined by c doublings."""
    pairs = [(_jac(p), s) for p, s in zip(points, scalars) if s and p is not None]
    if not pairs:
        return None
    c = max(1, len(pairs).bit_length() - 3)
    mask = (1 << c) - 1
    top = max(s for _, s in pairs).bit_length()
    acc = _JINF
    for w in range((top - 1) // c, -1, -1):
        for _ in range(c):
            acc = _jac_double(acc)
        buckets = [_JINF] * (1 << c)
        for p, s in pairs:
            d = (s >> (c * w)) & mask
            if d:
                buckets[d] = _jac_add(buckets[d], p)
        run = total = _JINF
        for d in range(mask, 0, -1):
            run = _jac_add(run, buckets[d])
            total = _jac_add(total, run)
        acc = _jac_add(acc, total)
    return _affine(acc)


def rand_points(n: int, seed: int = 0):
    """n random G1 points (as multiples of the generator)."""
    rng = random.Random(seed)
    from .fields import FR

    return [scalar_mul(G1_GEN, rng.randrange(1, FR.p)) for _ in range(n)]
