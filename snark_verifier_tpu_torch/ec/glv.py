"""The BN254 G1 endomorphism of the verify MSM's ladders (GLV):
φ(x, y) = (β·x, y) = λ·P for every P of G1, β a cube root of unity in Fq
and λ one in Fr.  A scalar k splits into k1 + λ·k2 ≡ k (mod r) with
|k1|, |k2| < 2^127, so `svt_msm_windowed` (csrc/msm_loops.cuh) runs each
ladder over 32 windows of 4 bits, adding T[d1] and φ(T[d2]) a window
(T[d] = d·(±P); φ's y negated where the halves' signs differ), in place
of 64 windows of one add: half the doublings for an add and a multiply
more a window.

Everything here is derived from p, r and the generator with python ints:

* BETA, LAMBDA: the pair of nontrivial cube roots of unity with
  φ(G) = λ·G (of the two pairs, the one whose roots are smaller);
* the short basis (A1, B1), (A2, B2) of the lattice {(a, b): a + b·λ ≡ 0
  (mod r)}, from the extended Euclidean algorithm on (r, λ) (GLV, 2001);
* G1 = round(2^256 B2 / r), G2 = round(-2^256 B1 / r): Babai's rounding
  c1 = round(k B2 / r), c2 = round(-k B1 / r) as one product and a shift.

`split` is the kernel's integer formula; tests/test_torch_msm_loops.py
holds the kernel's literals (`kernel_constants`) and the bound to it."""

from __future__ import annotations

import math

from ..ff.spec import FQ, FR
from . import py_ec

P, R = FQ.p, FR.p
HALF_BITS = 128  # |k1|, |k2| < 2^127: 32 windows of 4 bits, the top one's digit < 8


def _cube_roots(m: int):
    """The two nontrivial cube roots of unity mod prime m (3 | m - 1)."""
    for g in range(2, 1000):
        w = pow(g, (m - 1) // 3, m)
        if w != 1:
            return w, w * w % m
    raise ValueError("no cube root of unity found")


def _pair():
    g = py_ec.G1_GEN
    pairs = [(b, lam) for b in _cube_roots(P) for lam in _cube_roots(R)
             if py_ec.scalar_mul(g, lam) == (b * g[0] % P, g[1])]
    return min(pairs)


BETA, LAMBDA = _pair()


def _basis(n: int, lam: int):
    """Two short vectors (a, b), a + b·lam ≡ 0 (mod n): the remainders of
    the extended Euclidean algorithm around sqrt(n)."""
    rows = [(n, 0), (lam, 1)]  # (remainder, t) with remainder ≡ t·lam (mod n)
    while rows[-1][0]:
        (r0, t0), (r1, t1) = rows[-2:]
        q = r0 // r1
        rows.append((r0 - q * r1, t0 - q * t1))
    last = max(i for i, (ri, _) in enumerate(rows) if ri >= math.isqrt(n))
    v1 = (rows[last + 1][0], -rows[last + 1][1])
    v2 = min((rows[last][0], -rows[last][1]), (rows[last + 2][0], -rows[last + 2][1]),
             key=lambda v: v[0] ** 2 + v[1] ** 2)
    return v1, v2


(A1, B1), (A2, B2) = _basis(R, LAMBDA)
G1 = (B2 << 256) // R + ((B2 << 256) % R * 2 >= R)
G2 = (-B1 << 256) // R + ((-B1 << 256) % R * 2 >= R)


def split(k: int):
    """k (0 <= k < 2^256) -> (k1, k2), k1 + LAMBDA·k2 ≡ k (mod r), by the
    kernel's integer formula (csrc/msm_loops.cuh: glv_split)."""
    c1 = (k * G1 + (1 << 255)) >> 256
    c2 = (k * G2 + (1 << 255)) >> 256
    return k - c1 * A1 - c2 * A2, c1 * -B1 - c2 * B2


def _words(v: int, n: int):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def kernel_constants():
    """{name: words} of the kernel's literals, least significant first:
    BETA in Montgomery form (8 words), G1 (3), G2 (5), A1 (2), A2 (4),
    -B1 (4), B2 (2)."""
    return {"GLV_BETA": _words(BETA * (1 << 256) % P, 8), "GLV_G1": _words(G1, 3),
            "GLV_G2": _words(G2, 5), "GLV_A1": _words(A1, 2), "GLV_A2": _words(A2, 4),
            "GLV_NB1": _words(-B1, 4), "GLV_B2": _words(B2, 2)}
