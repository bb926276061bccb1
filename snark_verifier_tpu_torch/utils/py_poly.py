"""Host-side univariate polynomial arithmetic over Fr (python ints): a
copy of the JAX package's `utils/py_poly.py`.

Coefficient lists, lowest degree first.  The host provers
(`system/*_plonk.py`, `pcs/kzg/prover_py.py`, `pcs/ipa`) build their
polynomials with it; the card sees only their commitments (`Srs.commit`).
Mirrors the role of the reference's `util::poly::Polynomial`.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ff.spec import FR

R = FR.p


def trim(p: List[int]) -> List[int]:
    while p and p[-1] % R == 0:
        p.pop()
    return p


def padd(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R for i in range(n)]


def psub(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % R for i in range(n)]


def pscale(a: Sequence[int], k: int) -> List[int]:
    return [c * k % R for c in a]


def pmul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == 0:
            continue
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % R
    return out


def peval(p: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % R
    return acc


def pdiv_linear(p: Sequence[int], z: int) -> List[int]:
    """Exact division by (X - z) via synthetic division; requires p(z) == 0."""
    assert peval(p, z) == 0, "not divisible by (X - z)"
    out = [0] * (len(p) - 1)
    acc = 0
    for i in range(len(p) - 1, 0, -1):
        acc = (acc * z + p[i]) % R
        out[i - 1] = acc
    return out


def vanishing(zs: Sequence[int]) -> List[int]:
    """Π (X - z_i)."""
    out = [1]
    for z in zs:
        out = pmul(out, [(-z) % R, 1])
    return out


def pdivmod(num: Sequence[int], den: Sequence[int]):
    """Polynomial long division; returns (quotient, remainder)."""
    num = list(num)
    den = trim(list(den))
    dlead_inv = pow(den[-1], -1, R)
    q = [0] * max(0, len(num) - len(den) + 1)
    while len(trim(num)) >= len(den):
        shift = len(num) - len(den)
        factor = num[-1] * dlead_inv % R
        q[shift] = factor
        for i, c in enumerate(den):
            num[shift + i] = (num[shift + i] - factor * c) % R
        num.pop()
    return q, trim(num)


def ntt(a: Sequence[int], omega: int) -> List[int]:
    """In-place-style iterative radix-2 NTT over Fr: coefficient form ->
    evaluations at [omega^0 .. omega^(n-1)].  n = len(a) must be a power of
    two and omega a primitive n-th root of unity.  O(n log n) python-int
    butterflies — the host analogue of halo2's domain FFT the reference leans
    on (util/arithmetic.rs:131-162 context)."""
    n = len(a)
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    a = [x % R for x in a]
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    return a


def intt(a: Sequence[int], omega: int) -> List[int]:
    """Inverse NTT: evaluations on the omega-domain -> coefficients."""
    n = len(a)
    out = ntt(a, pow(omega, -1, R))
    n_inv = pow(n, -1, R)
    return [x * n_inv % R for x in out]


def pmul_ntt(a: Sequence[int], b: Sequence[int], omega_2adic_gen=None) -> List[int]:
    """Coefficient product via NTT (falls back to schoolbook for tiny sizes)."""
    if not a or not b:
        return []
    out_len = len(a) + len(b) - 1
    if out_len <= 64:
        return pmul(a, b)
    n = 1 << (out_len - 1).bit_length()
    root = _root_of_unity(n.bit_length() - 1)
    fa = ntt(list(a) + [0] * (n - len(a)), root)
    fb = ntt(list(b) + [0] * (n - len(b)), root)
    return intt([x * y % R for x, y in zip(fa, fb)], root)[:out_len]


def _root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (generator 7, as halo2curves)."""
    assert k <= FR.two_adicity
    return pow(7, (R - 1) >> k, R)


def pdiv_vanishing(num: Sequence[int], n: int):
    """Divide by (X^n - 1) in O(len(num)): returns (quotient, remainder).
    Folding from the top: X^i = X^(i-n) mod (X^n - 1)."""
    num = [c % R for c in num]
    q = [0] * max(0, len(num) - n)
    for i in range(len(num) - 1, n - 1, -1):
        c = num[i]
        if c:
            q[i - n] = (q[i - n] + c) % R
            num[i - n] = (num[i - n] + c) % R
    return q, trim(num[:n])


def lagrange_interpolate(points) -> List[int]:
    """Interpolating polynomial through [(x_i, y_i)] (distinct x)."""
    out: List[int] = []
    for i, (xi, yi) in enumerate(points):
        num = [1]
        den = 1
        for j, (xj, _) in enumerate(points):
            if i == j:
                continue
            num = pmul(num, [(-xj) % R, 1])
            den = den * (xi - xj) % R
        out = padd(out, pscale(num, yi * pow(den, -1, R) % R))
    return out


def rand_poly(deg: int, rng) -> List[int]:
    return [rng.randrange(R) for _ in range(deg + 1)]
