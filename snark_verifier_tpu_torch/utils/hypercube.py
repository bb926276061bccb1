"""BooleanHypercube: the GF(2^n)-LFSR iteration of the n-dimensional
boolean hypercube.  A plain copy of the JAX package's `utils/hypercube.py`
(the reference's snark-verifier src/util/arithmetic.rs:309-445, used by its
multilinear layers).

The reference hard-codes one primitive polynomial per degree; here they are
generated: the lexicographically smallest primitive polynomial of each
degree (which reproduces the reference's table — both pick the canonical
minimal ones).  x^{-1} = (p ^ 1) >> 1 since p has a constant term.
"""

from __future__ import annotations

import functools
from typing import Iterator


def _prime_factors(n: int):
    out = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def _gf2_mulmod(a: int, b: int, p: int, n: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> n:
            a ^= p
    return r


def _gf2_powmod(a: int, e: int, p: int, n: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf2_mulmod(r, a, p, n)
        a = _gf2_mulmod(a, a, p, n)
        e >>= 1
    return r


def _is_primitive(p: int, n: int) -> bool:
    order = (1 << n) - 1
    if _gf2_powmod(2, order, p, n) != 1:  # 2 encodes the element x
        return False
    return all(_gf2_powmod(2, order // q, p, n) != 1 for q in _prime_factors(order))


@functools.lru_cache(maxsize=None)
def primitive_poly(n: int) -> int:
    """Smallest primitive polynomial of degree n over GF(2), as an int."""
    if n == 0:
        return 1
    if n == 1:
        return 3  # x + 1
    for p in range((1 << n) + 1, 1 << (n + 1), 2):  # constant term required
        if _is_primitive(p, n):
            return p
    raise AssertionError("unreachable: a primitive polynomial of every degree exists")


class BooleanHypercube:
    """Iterates {0,1}^n as 0 followed by the x^k orbit of the LFSR."""

    def __init__(self, num_vars: int):
        if not 0 <= num_vars < 32:
            raise ValueError(f"BooleanHypercube: {num_vars} variables (0 to 31)")
        self.num_vars = num_vars
        self.primitive = primitive_poly(num_vars)
        self.x_inv = (self.primitive ^ 1) >> 1

    def next(self, b: int) -> int:
        b <<= 1
        if b >> self.num_vars:
            b ^= self.primitive
        return b & ((1 << self.num_vars) - 1)

    def prev(self, b: int) -> int:
        return (b >> 1) ^ ((b & 1) * self.x_inv)

    def rotate(self, b: int, rotation: int) -> int:
        for _ in range(rotation, 0):
            b = self.prev(b)
        for _ in range(0, rotation):
            b = self.next(b)
        return b

    def __iter__(self) -> Iterator[int]:
        yield 0
        if self.num_vars == 0:
            return
        b = 1
        for _ in range((1 << self.num_vars) - 1):
            yield b
            b = self.next(b)
