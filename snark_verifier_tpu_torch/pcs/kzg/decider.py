"""The KZG accumulation decider: the final pairing check
e(lhs, g2) · e(rhs, −s·g2) == 1, one multi-Miller loop and one final
exponentiation per accumulator.  The counterpart of the JAX package's
`pcs/kzg/decider.py` (`decide` :19-37, `decide_all` :40-44); the G2 lines
come prepared from the SRS (`Srs.decider_coeffs`).  Each `decide` call
counts 2 pairings into `utils.timing.METER`, as the JAX package does.
"""

from __future__ import annotations

import torch

from ...pairing.pairing import pairing_check
from ...utils.timing import METER


def decide(srs, lhs, rhs):
    """lhs, rhs: (..., 3, 8) projective G1 words -> (...,) bool.

    Inversion-free: the lines are evaluated at the projective points, each
    scaled by Z (an Fq factor the final exponentiation kills), so no
    normalisation to affine is needed.  A Z = 0 input (the point at
    infinity, (0 : 1 : 0)) contributes the identity e(O, Q) = 1: its scaled
    lines collapse into Fq2, which the easy part of the final
    exponentiation sends to 1.  So a lane whose lhs and rhs are both the
    identity decides true."""
    METER.count("pairing", 2)
    lhs, rhs = torch.broadcast_tensors(lhs, rhs)
    batch = lhs.shape[:-2]
    pts = torch.stack([lhs, rhs], dim=-3).reshape(-1, 2, 3, 8)  # (n, pair, coord, 8)
    xs, ys, zs = (pts[:, :, k].contiguous() for k in range(3))
    ok = pairing_check(xs, ys, zs, srs.decider_coeffs(lhs.device))
    return ok.reshape(batch)


def decide_all(srs, accumulators):
    """accumulators: a list of (lhs, rhs), each (B, 3, 8) -> (n_accs, B)
    bool, one batched decide."""
    lhs = torch.stack([a[0] for a in accumulators], 0)
    rhs = torch.stack([a[1] for a in accumulators], 0)
    return decide(srs, lhs, rhs)
