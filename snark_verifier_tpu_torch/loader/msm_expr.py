"""The lazy MSM expression `constant·g + Σ scalarᵢ·baseᵢ`: the counterpart
of the JAX package's `loader/msm_expr.py` (the reference's symbolic `Msm`).

Verifier layers build it with operator overloading; `evaluate` lowers it in
one shot.  Scalars are (B, 8) or (8,) Fr Montgomery words (None for the
coefficient 1), bases (B, 3, 8) or (3, 8) projective G1 words, all on one
device.  `evaluate` is the JAX package's positional branch (:102-150):
the bases with their canonical scalars go to `msm/cuda_ops.py::msm_windowed`
(4-bit windows), one launch of the kernel `svt_msm_windowed` on the card.
(The JAX package's RNS branch is the TPU's own coordinate layout and has no
counterpart here.)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ff import FRW
from ..msm import cuda_ops


class MsmExpr:
    def __init__(self, constant=None, pairs: Optional[List[Tuple]] = None):
        self.const = constant  # Fr scalar (coefficient of the generator g)
        self.pairs = list(pairs or [])  # [(scalar | None, point)]

    @staticmethod
    def base(point) -> "MsmExpr":
        return MsmExpr(pairs=[(None, point)])

    @staticmethod
    def constant(scalar) -> "MsmExpr":
        return MsmExpr(constant=scalar)

    # ------------------------------------------------------------- algebra

    def __add__(self, other: "MsmExpr") -> "MsmExpr":
        c = self.const
        if other.const is not None:
            c = other.const if c is None else FRW.add(c, other.const)
        return MsmExpr(c, self.pairs + other.pairs)

    def __sub__(self, other: "MsmExpr") -> "MsmExpr":
        return self + (-other)

    def __neg__(self) -> "MsmExpr":
        c = None if self.const is None else FRW.neg(self.const)
        pairs = []
        for s, p in self.pairs:
            if s is None:
                s = FRW.const("ONE", p.device)
            pairs.append((FRW.neg(s), p))
        return MsmExpr(c, pairs)

    def __mul__(self, scalar) -> "MsmExpr":
        c = None if self.const is None else FRW.mul(self.const, scalar)
        pairs = [(scalar if s is None else FRW.mul(s, scalar), p) for s, p in self.pairs]
        return MsmExpr(c, pairs)

    def __rmul__(self, scalar) -> "MsmExpr":
        return self * scalar

    def size(self) -> int:
        return len(self.pairs)

    def try_constant(self, zero):
        """The constant scalar if there are no bases (`zero` if there is no
        constant either), else None."""
        if self.pairs:
            return None
        return self.const if self.const is not None else zero

    def split(self):
        """(the bases-only MsmExpr, the constant scalar or None)."""
        return MsmExpr(None, self.pairs), self.const

    @staticmethod
    def sum(exprs: List["MsmExpr"]) -> "MsmExpr":
        out = MsmExpr()
        for e in exprs:
            out = out + e
        return out

    # ------------------------------------------------------------ evaluate

    def evaluate(self, g, batch: int, device):
        """-> (batch, 3, 8) projective words.  `g` (3, 8) is the generator
        the constant term multiplies."""
        scaled_pts, scaled_scalars, plain_pts = [], [], []
        for s, p in self.pairs:
            if s is None:
                plain_pts.append(p)
            else:
                scaled_pts.append(p)
                scaled_scalars.append(s)
        if self.const is not None:
            scaled_pts.append(g)
            scaled_scalars.append(self.const)

        acc = None
        if scaled_pts:
            pts = torch.stack([p.expand(batch, 3, 8) for p in scaled_pts], 1)  # (B, n, 3, 8)
            scs = torch.stack([s.expand(batch, 8) for s in scaled_scalars], 1)  # (B, n, 8)
            acc = cuda_ops.msm_windowed(pts, FRW.from_mont(scs), c=4)
        for p in plain_pts:
            p = p.expand(batch, 3, 8).contiguous()
            acc = p if acc is None else cuda_ops.add(acc, p)
        if acc is None:
            acc = cuda_ops.identity((batch,), device).contiguous()
        return acc
