"""Pure-Python BN254 pairing oracle and host-side G2 line preparation:
a copy of the JAX package's `pairing/py_pairing.py`, kept here so the port
imports nothing of that package, plus `f2_sqrt` for decoding the SRS's G2
points.

Roles:
  1. the gold model for the port's tower and pairing kernels;
  2. `prepare_g2`, the host-side Miller-loop line coefficients the kernels
     consume (the decider's G2 points are fixed SRS points, so the
     fixed-argument precomputation applies).

Towers: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³-ξ) with ξ = 9+u,
Fq12 = Fq6[w]/(w²-v).  D-type twist y² = x³ + 3/ξ.  Optimal ate Miller loop
over NAF(6x+2), Frobenius end steps, final exponentiation (p¹²-1)/r as a
direct pow (the oracle need not be fast).
"""

from __future__ import annotations

from typing import List, Tuple

from ..ff.spec import FQ, FR, BN254_X

P = FQ.p
X = BN254_X

# ---------------------------------------------------------------------- Fq2
# elements are (c0, c1) tuples of ints: c0 + c1*u, u^2 = -1

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
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


def f2_smul(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def f2_pow(a, e: int):
    r = FQ2_ONE
    while e:
        if e & 1:
            r = f2_mul(r, a)
        a = f2_sq(a)
        e >>= 1
    return r


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


# ---------------------------------------------------------------------- Fq6
# (c0, c1, c2) over Fq2: c0 + c1 v + c2 v², v³ = ξ

F6_ZERO = (FQ2_ZERO,) * 3
F6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f2_mul_xi(a):
    """a * ξ = a*(9+u)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    """a * v: (c2 ξ, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


# --------------------------------------------------------------------- Fq12
# (c0, c1) over Fq6: c0 + c1 w, w² = v

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    c0 = f6_add(t0, f6_mul_by_v(t1))
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_by_v(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, a)
        a = f12_sq(a)
        e >>= 1
    return r


def f12_mul_by_034(f, c0, c3, c4):
    """f * (c0 + c3 w + c4 v w) — sparse line multiplication.

    The line element is a + b·w with a = (c0, 0, 0), b = (c3, c4, 0) in Fq6.
    """
    a = (c0, FQ2_ZERO, FQ2_ZERO)
    b = (c3, c4, FQ2_ZERO)
    return f12_mul(f, (a, b))


# Frobenius coefficients (host-computed, exact)
FROB_FQ12_C1 = [f2_pow(XI, (P**i - 1) // 6) for i in range(12)]
FROB_FQ6_C1 = [f2_pow(XI, (P**i - 1) // 3) for i in range(6)]
FROB_FQ6_C2 = [f2_pow(XI, 2 * (P**i - 1) // 3) for i in range(6)]
XI_TO_Q_MINUS_1_OVER_2 = f2_pow(XI, (P - 1) // 2)


def f2_frob(a, power: int):
    return a if power % 2 == 0 else f2_conj(a)


def f6_frob(a, power: int):
    c0 = f2_frob(a[0], power)
    c1 = f2_mul(f2_frob(a[1], power), FROB_FQ6_C1[power % 6])
    c2 = f2_mul(f2_frob(a[2], power), FROB_FQ6_C2[power % 6])
    return (c0, c1, c2)


def f12_frob(a, power: int):
    c0 = f6_frob(a[0], power)
    c1 = f6_frob(a[1], power)
    c1 = tuple(f2_mul(x, FROB_FQ12_C1[power % 12]) for x in c1)
    return (c0, c1)


# ----------------------------------------------------------------- G2 (E')
# affine points over Fq2: (x, y) tuples or None for infinity
# curve: y² = x³ + b', b' = 3/ξ

B2 = f2_mul((3, 0), f2_inv(XI))
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == FQ2_ZERO


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == FQ2_ZERO:
            return None
        return g2_double(p1)
    lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(p1):
    if p1 is None:
        return None
    x1, y1 = p1
    if y1 == FQ2_ZERO:
        return None
    lam = f2_mul(f2_smul(f2_sq(x1), 3), f2_inv(f2_smul(y1, 2)))
    x3 = f2_sub(f2_sq(lam), f2_smul(x1, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p1):
    if p1 is None:
        return None
    return (p1[0], f2_neg(p1[1]))


def g2_scalar_mul(p1, k: int):
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p1)
        p1 = g2_double(p1)
        k >>= 1
    return acc


# --------------------------------------------------------- Miller loop prep


def naf(n: int) -> List[int]:
    """Non-adjacent form, least-significant digit first."""
    out = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            out.append(d)
            n -= d
        else:
            out.append(0)
        n >>= 1
    return out


SIX_X_PLUS_2 = 6 * X + 2
NAF_DIGITS = naf(SIX_X_PLUS_2)  # LSB first


def _dbl_step(r):
    """Jacobian doubling step on G2; returns (new_r, (c0, c3, c4)) line
    coefficients (to be scaled by P.y, P.x, 1 respectively)."""
    X1, Y1, Z1 = r
    A = f2_sq(X1)
    B = f2_sq(Y1)
    C = f2_sq(B)
    D = f2_smul(f2_sub(f2_sub(f2_sq(f2_add(X1, B)), A), C), 2)
    E = f2_smul(A, 3)
    F = f2_sq(E)
    Zsq = f2_sq(Z1)
    X3 = f2_sub(F, f2_smul(D, 2))
    Z3 = f2_sub(f2_sub(f2_sq(f2_add(Y1, Z1)), B), Zsq)  # 2 Y1 Z1
    Y3 = f2_sub(f2_mul(f2_sub(D, X3), E), f2_smul(C, 8))
    # line: l(P) = 2 Z3 Zsq * y_P  - 2 E Zsq * x_P + ((X1+E)² − A − F − 4B)
    c0 = f2_smul(f2_mul(Z3, Zsq), 2)
    c3 = f2_neg(f2_smul(f2_mul(E, Zsq), 2))
    c4 = f2_sub(f2_sub(f2_sub(f2_sq(f2_add(X1, E)), A), F), f2_smul(B, 4))
    return (X3, Y3, Z3), (c0, c3, c4)


def _add_step(r, q):
    """Mixed addition step r += q (q affine); returns (new_r, (c0, c3, c4))."""
    X1, Y1, Z1 = r
    x2, y2 = q
    Zsq = f2_sq(Z1)
    y2sq = f2_sq(y2)
    t0 = f2_mul(x2, Zsq)  # x2 Z²
    t1 = f2_mul(f2_sub(f2_sub(f2_sq(f2_add(y2, Z1)), y2sq), Zsq), Zsq)  # 2 y2 Z³
    th = f2_sub(t0, X1)  # θ_x
    t3 = f2_sq(th)
    t4 = f2_smul(t3, 4)
    t5 = f2_mul(t4, th)
    lam = f2_sub(t1, f2_smul(Y1, 2))  # 2(y2 Z³ − Y1)
    t7 = f2_mul(t4, X1)
    X3 = f2_sub(f2_sub(f2_sq(lam), t5), f2_smul(t7, 2))
    Z3 = f2_sub(f2_sub(f2_sq(f2_add(Z1, th)), Zsq), t3)  # 2 Z1 θ
    Y3 = f2_sub(f2_mul(f2_sub(t7, X3), lam), f2_smul(f2_mul(Y1, t5), 2))
    # line: l(P) = 2 Z3 y_P − 2λ x_P + 2(λ x2 − y2 Z3)
    c0 = f2_smul(Z3, 2)
    c3 = f2_neg(f2_smul(lam, 2))
    c4 = f2_sub(f2_smul(f2_mul(lam, x2), 2), f2_smul(f2_mul(y2, Z3), 2))
    return (X3, Y3, Z3), (c0, c3, c4)


def prepare_g2(q) -> List[Tuple]:
    """All line coefficients for the Miller loop with fixed Q (affine int
    tuple).  Mirrors the role of halo2curves' G2Prepared."""
    assert q is not None and g2_is_on_curve(q)
    coeffs = []
    r = (q[0], q[1], FQ2_ONE)
    negq = g2_neg(q)
    for d in reversed(NAF_DIGITS[:-1]):
        r, c = _dbl_step(r)
        coeffs.append(("dbl", c))
        if d == 1:
            r, c = _add_step(r, q)
            coeffs.append(("add", c))
        elif d == -1:
            r, c = _add_step(r, negq)
            coeffs.append(("add", c))
    # frobenius end steps
    q1 = (
        f2_mul(f2_conj(q[0]), FROB_FQ6_C1[1]),
        f2_mul(f2_conj(q[1]), XI_TO_Q_MINUS_1_OVER_2),
    )
    minus_q2 = (f2_mul(q[0], FROB_FQ6_C1[2]), q[1])
    r, c = _add_step(r, q1)
    coeffs.append(("add", c))
    r, c = _add_step(r, minus_q2)
    coeffs.append(("add", c))
    return coeffs


def miller_loop(pairs) -> Tuple:
    """pairs: list of ((x, y) G1 affine ints, coeffs from prepare_g2)."""
    f = F12_ONE
    iters = [list() for _ in range(len(NAF_DIGITS))]
    # replay coefficient streams in lockstep with the NAF schedule
    idx = [0] * len(pairs)
    first = True
    for d in reversed(NAF_DIGITS[:-1]):
        if not first:
            f = f12_sq(f)
        first = False
        for k, (p, coeffs) in enumerate(pairs):
            kind, c = coeffs[idx[k]]
            assert kind == "dbl"
            idx[k] += 1
            f = _ell(f, c, p)
        if d != 0:
            for k, (p, coeffs) in enumerate(pairs):
                kind, c = coeffs[idx[k]]
                assert kind == "add"
                idx[k] += 1
                f = _ell(f, c, p)
    for _ in range(2):  # frobenius end steps
        for k, (p, coeffs) in enumerate(pairs):
            kind, c = coeffs[idx[k]]
            idx[k] += 1
            f = _ell(f, c, p)
    return f


def _ell(f, c, p):
    x, y = p
    c0 = f2_smul(c[0], y)
    c3 = f2_smul(c[1], x)
    return f12_mul_by_034(f, c0, c3, c[2])


def final_exponentiation(f) -> Tuple:
    """Oracle: direct pow by (p^12 - 1) // r."""
    return f12_pow(f, (P**12 - 1) // FR.p)


def pairing(p, q) -> Tuple:
    """e(P, Q) for affine int points; P in G1, Q in G2."""
    f = miller_loop([(p, prepare_g2(q))])
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """Π e(Pᵢ, Qᵢ) == 1 (multi-Miller-loop then one final exp)."""
    f = miller_loop([(p, prepare_g2(q)) for p, q in pairs])
    return final_exponentiation(f) == F12_ONE
