"""The Poseidon sponge over BN254 Fr in python ints (x^5, T = 3, RATE = 2,
R_F = 8, R_P = 57, Grain constants): a frozen copy of the port's
`hash/poseidon.py::PoseidonPy`.  `PERMUTATIONS` counts the permutations
run in this process, the work count of the absorb kernels' roofline."""

from __future__ import annotations

import functools
from typing import List, Sequence

from .fields import FR
from .grain import generate_constants

T, RATE, R_F, R_P = 3, 2, 8, 57

PERMUTATIONS = [0]


@functools.lru_cache(maxsize=None)
def get_spec(t: int = T, r_f: int = R_F, r_p: int = R_P):
    """(round_constants[(r_f+r_p)][t], mds[t][t], is_full[r_f+r_p]) ints."""
    rcs, mds = generate_constants(FR.p, 254, t, r_f, r_p)
    half = r_f // 2
    is_full = [r < half or r >= half + r_p for r in range(r_f + r_p)]
    return rcs, mds, is_full


class PoseidonPy:
    """The sponge: capacity element 2^64, RATE-chunks absorbed into
    state[1..], a short final chunk padded with one 1, an exact multiple
    (empty included) followed by one all-padding permutation; the squeeze
    is state[1]."""

    def __init__(self, t: int = T, rate: int = RATE, r_f: int = R_F, r_p: int = R_P):
        self.p = FR.p
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.rcs, self.mds, self.is_full = get_spec(t, r_f, r_p)
        self.state = [1 << 64] + [0] * (t - 1)
        self.buf: List[int] = []

    def permutation(self, inputs: Sequence[int]):
        p, t = self.p, self.t
        s = list(self.state)
        if len(inputs) >= t:
            raise ValueError("a permutation absorbs at most t - 1 elements")
        for i, v in enumerate(inputs):
            s[1 + i] = (s[1 + i] + v) % p
        if len(inputs) < self.rate:
            s[1 + len(inputs)] = (s[1 + len(inputs)] + 1) % p
        for r in range(self.r_f + self.r_p):
            s = [(x + c) % p for x, c in zip(s, self.rcs[r])]
            if self.is_full[r]:
                s = [pow(x, 5, p) for x in s]
            else:
                s[0] = pow(s[0], 5, p)
            s = [sum(self.mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]
        self.state = s
        PERMUTATIONS[0] += 1

    def update(self, elements: Sequence[int]):
        self.buf.extend(int(e) % self.p for e in elements)

    def squeeze(self) -> int:
        buf, self.buf = self.buf, []
        for i in range(0, len(buf), self.rate):
            self.permutation(buf[i : i + self.rate])
        if len(buf) % self.rate == 0:
            self.permutation([])
        return self.state[1]
