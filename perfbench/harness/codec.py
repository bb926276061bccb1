"""Read the program's outputs as python ints: its G1 points are
homogeneous projective (X : Y : Z) over Fq in Montgomery form x·R mod p
(R = 2^256), as 8 little-endian 32-bit words (int32 bit patterns) or 16
little-endian 16-bit limbs a coordinate; Z = 0 is the identity."""

from __future__ import annotations

import numpy as np

from reference.fields import FQ

_RINV = pow(1 << 256, -1, FQ.p)


def _coord(row, width: int) -> int:
    mask = (1 << width) - 1
    return sum((int(v) & mask) << (width * i) for i, v in enumerate(row))


def affine(point, width: int):
    """One (3, 256 // width) point -> (x, y) ints, or None for the identity."""
    arr = np.asarray(point).reshape(3, 256 // width)
    x, y, z = (_coord(arr[k], width) * _RINV % FQ.p for k in range(3))
    if z == 0:
        return None
    zi = pow(z, -1, FQ.p)
    return (x * zi % FQ.p, y * zi % FQ.p)


def encode(pt, width: int) -> np.ndarray:
    """(x, y) ints or None -> one (3, 256 // width) point as the program
    lays it out (Z = 1 in Montgomery form; the identity (0 : 1 : 0)), int32
    words for width 32, int64 limbs for width 16."""
    r = 1 << 256
    coords = (0, r % FQ.p, 0) if pt is None else (pt[0] * r % FQ.p, pt[1] * r % FQ.p, r % FQ.p)
    mask = (1 << width) - 1
    rows = [[(c >> (width * i)) & mask for i in range(256 // width)] for c in coords]
    if width == 32:
        return np.array(rows, dtype=np.uint32).view(np.int32)
    return np.array(rows, dtype=np.int64)
