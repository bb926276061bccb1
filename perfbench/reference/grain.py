"""Grain-LFSR generation of Poseidon round constants and MDS matrix.

A frozen copy of the port's `hash/grain.py` (pure Python ints).  Reproduces the constant stream of the
`poseidon-circuit` crate's `Poseidon128Pow5Gen` spec used by the reference
(snark-verifier src/util/hash/poseidon.rs:14-51: T/RATE/R_F/
R_P generic, sbox x^5, SECURE_MDS=0), which itself follows the Poseidon paper
(eprint 2019/458) Grain LFSR.  Validated against the reference's KATs:
MDS values (poseidon/tests.rs:10-26) and hadeshash permutation vectors
(poseidon/tests.rs:35-85).

Stream layout: round constants first ((R_F+R_P) rows of T, rejection
sampling), then the Cauchy MDS inputs (2T elements, no rejection).
"""

from __future__ import annotations

from typing import List, Tuple

STATE = 80


class Grain:
    def __init__(self, p: int, num_bits: int, t: int, r_f: int, r_p: int):
        self.p = p
        self.num_bits = num_bits
        bits = [0] * STATE

        def set_bits(offset: int, length: int, value: int):
            # value encoded MSB-first within its window
            for i in range(length):
                bits[offset + i] = (value >> (length - 1 - i)) & 1

        set_bits(0, 2, 1)  # field type: prime order
        set_bits(2, 4, 0)  # sbox: x^alpha
        set_bits(6, 12, num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        set_bits(50, 30, (1 << 30) - 1)
        self.bits = bits
        # discard the first 160 output bits
        for _ in range(2 * STATE):
            self._next_bit()

    def _next_bit(self) -> int:
        b = self.bits
        new = b[62] ^ b[51] ^ b[38] ^ b[23] ^ b[13] ^ b[0]
        self.bits = b[1:] + [new]
        return new

    def _sample_bit(self) -> int:
        # self-shrinking: evaluate bits in pairs — if the first is 1 the
        # second is output, otherwise it is discarded
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def _sample_int(self) -> int:
        """num_bits sample bits, MSB first."""
        v = 0
        for _ in range(self.num_bits):
            v = (v << 1) | self._sample_bit()
        return v

    def next_field_element(self) -> int:
        """Rejection sampling: resample until < p."""
        while True:
            v = self._sample_int()
            if v < self.p:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Direct modular reduction of the raw sample."""
        return self._sample_int() % self.p


def generate_constants(
    p: int, num_bits: int, t: int, r_f: int, r_p: int
) -> Tuple[List[List[int]], List[List[int]]]:
    """Returns (round_constants[(r_f+r_p)][t], mds[t][t])."""
    grain = Grain(p, num_bits, t, r_f, r_p)
    rcs = [[grain.next_field_element() for _ in range(t)] for _ in range(r_f + r_p)]

    # Cauchy MDS from 2t distinct non-rejected elements (SECURE_MDS=0).
    while True:
        vals = [grain.next_field_element_without_rejection() for _ in range(2 * t)]
        if len(set(vals)) == 2 * t:
            xs, ys = vals[:t], vals[t:]
            break
    mds = [[pow(xs[i] + ys[j], -1, p) for j in range(t)] for i in range(t)]
    return rcs, mds
