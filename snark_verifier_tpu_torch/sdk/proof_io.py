"""G1 point decoding: the part of the JAX package's `sdk/proof_io.py` that
loading an SRS calls.

The halo2curves-native encoding: a coordinate is 32 little-endian bytes of
its reduced value; a G1 point is 32 bytes of compressed x, the parity of
the canonical y in bit 7 of byte 31, the identity all zeros.  Decoding
checks that x is reduced and that the point decompresses onto the curve,
raising `errors.TranscriptError` otherwise.
"""

from __future__ import annotations

from .. import errors
from ..ff.spec import FQ

Q = FQ.p


def fq_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= Q:
        raise errors.TranscriptError("Invalid coordinate encoding in proof")
    return v


def g1_from_bytes(b: bytes):
    """Decompress, which checks that the point is on the curve."""
    raw = bytearray(b)
    ysign = raw[31] >> 7
    raw[31] &= 0x7F
    x = fq_from_bytes(bytes(raw))
    if x == 0 and not ysign:
        return None  # identity
    y2 = (x * x * x + 3) % Q
    y = pow(y2, (Q + 1) // 4, Q)  # q = 3 mod 4
    if y * y % Q != y2:
        raise errors.TranscriptError("point not on curve (no sqrt)")
    if (y & 1) != ysign:
        y = Q - y
    return (x, y)
