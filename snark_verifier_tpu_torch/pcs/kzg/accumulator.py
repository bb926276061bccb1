"""The accumulator limb encoding (LIMBS = 3, BITS = 88): the counterpart of
the JAX package's `pcs/kzg/accumulator.py`.

An aggregation snark exposes its folded (lhs, rhs) G1 accumulator as 4 × 3
Fr instances, each coordinate in three 88-bit limbs (the reference's
accumulator.rs:50-78 and the SDK's LIMBS / BITS); a protocol's
`accumulator_indices` names them, and the verifier decodes them as old
accumulators that the decide checks beside the fresh one.

  * `fq_from_limbs`, `accumulator_from_limbs` — the device decode on word
    tensors: Fr Montgomery words in, Fq Montgomery words out.  Each limb is
    masked to 88 bits before assembly, so a malicious encoding gives a
    garbage point and a failing pairing, not a fault.  The masks and shifts
    are plain torch integer work on int64 16-bit limbs; the Montgomery
    conversions go through `FRW` / `FQW`.
  * `accumulator_from_limbs_int`, `accumulator_to_limbs_int` — the host
    codec on python ints (`Snark.validate` decodes and checks on the host).
"""

from __future__ import annotations

from typing import List

import torch

from ...ff import FQW, FRW, NLIMBS, W, limbs_to_words, words_to_limbs

LIMBS = 3
BITS = 88


def _shift_limbs(x, nlimbs: int, nbits: int):
    """x · 2^(16·nlimbs + nbits) within a 16-limb buffer (high bits drop)."""
    if nlimbs:
        x = torch.cat([torch.zeros_like(x[..., :nlimbs]), x[..., : NLIMBS - nlimbs]], -1)
    if nbits:
        hi = (x << nbits) & 0xFFFF
        lo = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1] >> (W - nbits)], -1)
        x = hi | lo
    return x


def _mask_88(limbs):
    """The low 88 bits of (..., 16) limbs: five whole limbs and 8 bits."""
    keep = torch.zeros_like(limbs)
    keep[..., :5] = limbs[..., :5]
    keep[..., 5] = limbs[..., 5] & 0xFF
    return keep


def fq_from_limbs(limbs: List):
    """3 Fr Montgomery word tensors (..., 8) -> one Fq Montgomery word tensor:
    l0 + l1·2^88 + l2·2^176 of the masked canonical limbs."""
    c = _mask_88(words_to_limbs(FRW.from_mont(torch.stack(torch.broadcast_tensors(*limbs)))))
    # The three masked ranges do not overlap, so the sum has no carries.
    acc = c[0] + _shift_limbs(c[1], 5, 8) + _shift_limbs(c[2], 11, 0)
    return FQW.to_mont(limbs_to_words(acc))


def accumulator_from_limbs(limbs: List):
    """12 Fr Montgomery word tensors (..., 8) -> (lhs, rhs), each (..., 3, 8)
    projective G1 words with Z = 1."""
    if len(limbs) != 4 * LIMBS:
        raise ValueError(f"an accumulator takes {4 * LIMBS} limbs, got {len(limbs)}")
    flat = torch.stack(torch.broadcast_tensors(*limbs), -2)  # (..., 12, 8)
    by_coord = flat.reshape(*flat.shape[:-2], 4, LIMBS, 8)
    xy = fq_from_limbs(by_coord.unbind(-2))  # (..., 4, 8): lhs x, lhs y, rhs x, rhs y
    one = FQW.const("ONE", xy.device).expand(*xy.shape[:-2], 1, 8)
    return (torch.cat([xy[..., 0:2, :], one], -2).contiguous(),
            torch.cat([xy[..., 2:4, :], one], -2).contiguous())


def accumulator_from_limbs_int(limbs: List[int]):
    """Host: 12 Fr limb ints -> ((lhs_x, lhs_y), (rhs_x, rhs_y)) affine int
    points, the inverse of `accumulator_to_limbs_int`."""
    if len(limbs) != 4 * LIMBS:
        raise ValueError(f"an accumulator takes {4 * LIMBS} limbs, got {len(limbs)}")
    mask = (1 << BITS) - 1
    coords = [sum((limbs[i * LIMBS + j] & mask) << (BITS * j) for j in range(LIMBS))
              for i in range(4)]
    return (coords[0], coords[1]), (coords[2], coords[3])


def accumulator_to_limbs_int(acc) -> List[int]:
    """Host: affine int accumulator ((lhs_x, lhs_y), (rhs_x, rhs_y)) -> 12 Fr
    limb ints (the instance encoding of the reference's AggregationCircuit,
    snark-verifier-sdk/src/halo2/aggregation.rs:261-272)."""
    (lhs, rhs) = acc
    mask = (1 << BITS) - 1
    return [(v >> (BITS * i)) & mask for v in (lhs[0], lhs[1], rhs[0], rhs[1])
            for i in range(LIMBS)]
