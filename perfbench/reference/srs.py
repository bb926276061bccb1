"""What the reference needs of a KZG SRS file (halo2's 'Processed'
ParamsKZG layout: k as 4 bytes, 2^k compressed G1 powers, 2^k Lagrange
points, then G2's generator and [τ]G2): the generator g = [1]G1 and the
trapdoor τ of a toy SRS, made from a documented seed and checked against
the file's [τ]G1.

With s_g2 = [τ]G2, the decider's e(lhs, G2) = e(rhs, s_g2) holds exactly
when lhs = τ·rhs (the pairing is non-degenerate on groups of prime order),
so `decide` checks that instead of a pairing."""

from __future__ import annotations

import random
from dataclasses import dataclass

from . import py_ec
from .fields import FQ, FR


def g1_from_bytes(b: bytes):
    """A 32-byte compressed G1 point (little-endian x, the sign of y in the
    top bit) -> affine ints; None for the identity."""
    raw = bytearray(b)
    ysign = raw[31] >> 7
    raw[31] &= 0x7F
    x = int.from_bytes(bytes(raw), "little")
    if x >= FQ.p:
        raise ValueError("SRS point coordinate not reduced")
    if x == 0 and not ysign:
        return None
    y2 = (x * x * x + 3) % FQ.p
    y = pow(y2, (FQ.p + 1) // 4, FQ.p)
    if y * y % FQ.p != y2:
        raise ValueError("SRS point not on the curve")
    if (y & 1) != ysign:
        y = FQ.p - y
    return (x, y)


@dataclass
class ToySrs:
    g: tuple
    tau: int

    @staticmethod
    def load(path, trapdoor_seed: int) -> "ToySrs":
        with open(path, "rb") as f:
            head = f.read(4 + 64)
        g, tau_g = g1_from_bytes(head[4:36]), g1_from_bytes(head[36:68])
        tau = random.Random(trapdoor_seed).randrange(1, FR.p)
        if py_ec.scalar_mul(g, tau) != tau_g:
            raise ValueError("the SRS's [τ]G1 is not τ·G1 for this trapdoor seed")
        return ToySrs(g, tau)

    def decide(self, lhs, rhs) -> bool:
        return lhs == py_ec.scalar_mul(rhs, self.tau)
