"""The lazy MSM expression `constant·g + Σ scalarᵢ·baseᵢ`: the counterpart
of the JAX package's `loader/msm_expr.py` (the reference's symbolic `Msm`).

Verifier layers build it with operator overloading; the loader that made it
lowers it (`msm_evaluate`).  An expression keeps that loader and takes
every field op of its algebra from it, so an eager loader launches them and
a recording one (`loader/tape_loader.py`) records them.  Scalars and bases
are the loader's handles: for `TorchLoader` (B, 8) or (8,) Fr Montgomery
words (None for the coefficient 1) and (B, 3, 8) or (3, 8) projective G1
words.

`terms` lists what `msm_evaluate` lowers, in the JAX package's positional
order (:102-150): the scaled pairs, then the constant with the generator,
then the coefficient-1 bases.  `lower` is that branch's device side: the
scaled bases with their canonical scalars go to
`msm/cuda_ops.py::msm_windowed` (4-bit windows, one launch of
`svt_msm_windowed` on the card), and each coefficient-1 base is added to the
sum.  (The JAX package's RNS branch is the TPU's own coordinate layout and
has no counterpart here.)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..msm import cuda_ops


class MsmExpr:
    def __init__(self, L, constant=None, pairs: Optional[List[Tuple]] = None):
        self.L = L  # the loader whose field ops the algebra uses
        self.const = constant  # Fr scalar (coefficient of the generator g)
        self.pairs = list(pairs or [])  # [(scalar | None, point)]

    @staticmethod
    def base(L, point) -> "MsmExpr":
        return MsmExpr(L, pairs=[(None, point)])

    @staticmethod
    def constant(L, scalar) -> "MsmExpr":
        return MsmExpr(L, constant=scalar)

    # ------------------------------------------------------------- algebra

    def __add__(self, other: "MsmExpr") -> "MsmExpr":
        c = self.const
        if other.const is not None:
            c = other.const if c is None else self.L.add(c, other.const)
        return MsmExpr(self.L, c, self.pairs + other.pairs)

    def __sub__(self, other: "MsmExpr") -> "MsmExpr":
        return self + (-other)

    def __neg__(self) -> "MsmExpr":
        L = self.L
        c = None if self.const is None else L.neg(self.const)
        pairs = [(L.neg(L.scalar(1) if s is None else s), p) for s, p in self.pairs]
        return MsmExpr(L, c, pairs)

    def __mul__(self, scalar) -> "MsmExpr":
        L = self.L
        c = None if self.const is None else L.mul(self.const, scalar)
        pairs = [(scalar if s is None else L.mul(s, scalar), p) for s, p in self.pairs]
        return MsmExpr(L, c, pairs)

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
        return MsmExpr(self.L, None, self.pairs), self.const

    @staticmethod
    def sum(L, exprs: List["MsmExpr"]) -> "MsmExpr":
        out = MsmExpr(L)
        for e in exprs:
            out = out + e
        return out

    # ------------------------------------------------------------ evaluate

    def terms(self, g):
        """-> (scaled [(scalar, base)], plain [base]): the pairs with a
        scalar, then the constant times `g`, then the coefficient-1 bases."""
        scaled = [(s, p) for s, p in self.pairs if s is not None]
        if self.const is not None:
            scaled.append((self.const, g))
        return scaled, [p for s, p in self.pairs if s is None]


def lower(pts, canon_scalars, plain_pts, batch: int, device):
    """Σ canon_scalars·pts + Σ plain_pts -> (batch, 3, 8) projective words.
    pts (batch, n, 3, 8) with canonical scalars (batch, n, 8), both None when
    n = 0; plain_pts a list of (batch, 3, 8) or (3, 8) bases."""
    acc = None if pts is None else cuda_ops.msm_windowed(pts, canon_scalars, c=4)
    for p in plain_pts:
        p = p.expand(batch, 3, 8).contiguous()
        acc = p if acc is None else cuda_ops.add(acc, p)
    if acc is None:
        acc = cuda_ops.identity((batch,), device).contiguous()
    return acc
