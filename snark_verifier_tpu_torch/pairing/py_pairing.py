"""Fq2 and G2 over python ints: the pieces of the JAX package's
`pairing/py_pairing.py` that decoding the SRS's G2 points needs.

Fq2 = Fq[u]/(u² + 1); elements are (c0, c1) int tuples, c0 + c1·u.  G2 is
the D-type twist y² = x³ + 3/ξ, ξ = 9 + u, affine (x, y) tuples of Fq2
elements, None for infinity.
"""

from __future__ import annotations

from ..ff.spec import FQ

P = FQ.p

FQ2_ZERO = (0, 0)
XI = (9, 1)  # ξ = 9 + u


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sq(a):
    return f2_mul(a, a)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def f2_sqrt(a):
    """A square root in Fq2 (the complex method), None if a is no square."""
    c0, c1 = a

    def fq_sqrt(x):
        r = pow(x, (P + 1) // 4, P)  # q = 3 mod 4
        return r if r * r % P == x % P else None

    if c1 == 0:
        r = fq_sqrt(c0)
        if r is not None:
            return (r, 0)
        r = fq_sqrt((-c0) % P)
        return None if r is None else (0, r)
    lam = fq_sqrt((c0 * c0 + c1 * c1) % P)
    if lam is None:
        return None
    inv2 = pow(2, -1, P)
    x0 = fq_sqrt((c0 + lam) * inv2 % P)
    if x0 is None:
        x0 = fq_sqrt((c0 - lam) * inv2 % P)
        if x0 is None:
            return None
    return (x0, c1 * pow(2 * x0, -1, P) % P)


# ----------------------------------------------------------------- G2 (E')

B2 = f2_mul((3, 0), f2_inv(XI))  # b' = 3/ξ


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == FQ2_ZERO
