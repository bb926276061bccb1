"""The python-int loader the verifier runs under: a frozen copy of the
port's `loader/base.py::NativeLoader` (the reference's NativeLoader).
Scalars are python ints mod r, points affine int tuples; a lazy MSM is
evaluated by one Pippenger `py_ec.msm`, the same sum as the copy's loop of
scalar multiplications."""

from __future__ import annotations

from typing import List, Optional

from . import py_ec
from .fields import FR

ACC_LIMBS, ACC_BITS = 3, 88  # an instance-encoded accumulator coordinate


def accumulator_from_limbs_int(limbs: List[int]):
    """12 Fr limb ints -> ((lhs_x, lhs_y), (rhs_x, rhs_y)) affine int points."""
    if len(limbs) != 4 * ACC_LIMBS:
        raise ValueError(f"an accumulator takes {4 * ACC_LIMBS} limbs, got {len(limbs)}")
    mask = (1 << ACC_BITS) - 1
    coords = [sum((limbs[i * ACC_LIMBS + j] & mask) << (ACC_BITS * j) for j in range(ACC_LIMBS))
              for i in range(4)]
    return (coords[0], coords[1]), (coords[2], coords[3])


class NativeMsm:
    """Lazy `constant·g + Σ scalarᵢ·baseᵢ` over python ints."""

    __slots__ = ("const", "pairs")

    def __init__(self, constant: Optional[int] = None, pairs=None):
        self.const = constant
        self.pairs = list(pairs or [])  # [(int | None, (x, y))]

    @staticmethod
    def base(pt) -> "NativeMsm":
        return NativeMsm(pairs=[(None, pt)])

    @staticmethod
    def constant_term(s: int) -> "NativeMsm":
        return NativeMsm(constant=s)

    def __add__(self, other: "NativeMsm") -> "NativeMsm":
        c = self.const
        if other.const is not None:
            c = other.const if c is None else (c + other.const) % FR.p
        return NativeMsm(c, self.pairs + other.pairs)

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        r = FR.p
        c = None if self.const is None else (-self.const) % r
        pairs = [((-(s if s is not None else 1)) % r, p) for s, p in self.pairs]
        return NativeMsm(c, pairs)

    def __mul__(self, scalar: int) -> "NativeMsm":
        r = FR.p
        c = None if self.const is None else self.const * scalar % r
        pairs = [(scalar % r if s is None else s * scalar % r, p) for s, p in self.pairs]
        return NativeMsm(c, pairs)

    __rmul__ = __mul__

    def size(self) -> int:
        return len(self.pairs)

    def try_constant(self, zero=0):
        if self.pairs:
            return None
        return self.const if self.const is not None else zero

    def split(self):
        return NativeMsm(None, self.pairs), self.const

    def evaluate(self, g=None):
        points = [p for _, p in self.pairs]
        scalars = [1 if s is None else s for s, _ in self.pairs]
        if self.const is not None:
            if g is None:
                raise ValueError("the constant term needs the generator")
            points.append(g)
            scalars.append(self.const)
        return py_ec.msm(points, scalars)


class NativeLoader:
    def scalar(self, v: int) -> int:
        return v % FR.p

    def zero_scalar(self) -> int:
        return 0

    def add(self, a, b):
        return (a + b) % FR.p

    def sub(self, a, b):
        return (a - b) % FR.p

    def mul(self, a, b):
        return a * b % FR.p

    def neg(self, a):
        return (-a) % FR.p

    def batch_inv(self, xs: List[int]) -> List[int]:
        """Montgomery's trick, 0 -> 0."""
        r = FR.p
        n = len(xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = prefix[i] * (x if x else 1) % r
        inv_all = pow(prefix[n], r - 2, r)
        out = [0] * n
        for i in range(n - 1, -1, -1):
            x = xs[i]
            if x:
                out[i] = inv_all * prefix[i] % r
                inv_all = inv_all * x % r
        return out

    def pow_static(self, a: int, n: int) -> int:
        return pow(a, n, FR.p)

    def powers(self, x: int, n: int) -> List[int]:
        out = [1]
        for _ in range(n - 1):
            out.append(out[-1] * x % FR.p)
        return out

    def msm_zero(self):
        return NativeMsm()

    def msm_base(self, pt):
        return NativeMsm.base(pt)

    msm_base_int = msm_base

    msm_base_proj = msm_base

    def msm_constant(self, s: int):
        return NativeMsm.constant_term(s)

    def msm_is_identity(self, expr: NativeMsm) -> bool:
        return expr.evaluate(None) is None

    def affine(self, pt):
        return pt

    def msm_sum(self, exprs: List[NativeMsm]):
        out = NativeMsm()
        for e in exprs:
            out = out + e
        return out

    def msm_evaluate(self, expr: NativeMsm, g=None):
        return expr.evaluate(g)

    def accumulator_from_limbs(self, limbs: List[int]):
        return accumulator_from_limbs_int(limbs)


NATIVE = NativeLoader()
