"""Loader backends: the verifier is written once against a duck-typed
loader and run by interchangeable backends (the counterpart of the JAX
package's `loader/base.py`, the reference's loader design).

  * TorchLoader  — scalars are Fr Montgomery words ((B, 8) per lane, or one
    (8,) constant shared by the batch), points G1 words, all on one device.
    Eager: on the card every field op is a launch of csrc/field_kernels.cu
    and the MSM one of `svt_msm_windowed`; on the CPU the plain twins run.
    The verify path records its Fr work instead (`loader/tape_loader.py`,
    `verifier/plonk/plan.py`); this loader is the witness it is held to.
  * NativeLoader — scalars are python ints, points affine int tuples, ops go
    through the py_ec oracle: the port's own independent witness.

Loader interface:
  scalar(v:int) -> S           load a constant
  add/sub/mul/neg              field algebra on handles
  batch_inv([S]) -> [S]        batched inversion (0 -> 0)
  pow_static(S, n:int) -> S    exponentiation by a host int
  powers(S, n) -> [S]          [1, x, .., x^{n-1}]
  msm_zero()/msm_base(pt)/msm_base_int((x,y))/msm_constant(S) -> Expr
  msm_base_proj(P) -> Expr     a projective point handle as a base
  msm_sum([Expr]) -> Expr
  msm_evaluate(Expr, g) -> P   lower the lazy MSM (g = generator handle)
  msm_is_identity(Expr) -> bit(s)  the MSM is the identity: "lhs == rhs"
                               as "lhs - rhs is the identity"
  affine(P) -> pt              a point handle as the transcript absorbs it
  zero_scalar() -> S           the value of an empty Expr's constant
  accumulator_from_limbs([S]) -> (P, P)  decode an instance-encoded accumulator
  load_svk(srs) -> g           the generator handle the PCS verifiers take
                               (NativeLoader: `PlonkVerifier`)
  decide_all(srs, [(lhs, rhs)]) -> accept bit(s)  the pairing decide
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ec import py_ec
from ..ec.g1 import from_affine_int_np
from ..ff import FQW, FRW
from ..ff.spec import FR
from ..pcs.kzg.accumulator import accumulator_from_limbs, accumulator_from_limbs_int
from ..msm import cuda_ops
from .msm_expr import MsmExpr, lower


class TorchLoader:
    """Handles are word tensors of a batch of `batch` lanes on `device`."""

    def __init__(self, batch: int, device):
        self.batch = batch
        self.device = torch.device(device)
        self._bases: dict = {}

    # ------------------------------------------------------------- scalars

    def scalar(self, v: int):
        """The (8,) Montgomery constant, cached per (value, device): one
        upload per constant per process."""
        return FRW.scalar(v, self.device)

    def zero_scalar(self):
        return FRW.scalar(0, self.device)

    def add(self, a, b):
        return FRW.add(a, b)

    def sub(self, a, b):
        return FRW.sub(a, b)

    def mul(self, a, b):
        return FRW.mul(a, b)

    def neg(self, a):
        return FRW.neg(a)

    def batch_inv(self, xs: List) -> List:
        flat = torch.stack([x.expand(self.batch, 8) for x in xs], 0)
        inv = FRW.batch_inv(flat)
        return [inv[i] for i in range(len(xs))]

    def pow_static(self, a, n: int):
        return FRW.pow_static(a, n)

    def powers(self, x, n: int) -> List:
        return FRW.powers(x, n)

    # ----------------------------------------------------------------- msm

    def msm_zero(self):
        return MsmExpr(self)

    def msm_base(self, xy):
        """xy: (B, 2, 8) affine Fq words (a transcript handle)."""
        z = FQW.const("ONE", self.device).expand(*xy.shape[:-2], 1, 8)
        return MsmExpr.base(self, torch.cat([xy, z], -2))

    def msm_base_int(self, xy):
        """A host point (a protocol constant), uploaded once per device."""
        pt = self._bases.get(xy)
        if pt is None:
            pt = torch.from_numpy(from_affine_int_np([xy])[0]).to(self.device)
            self._bases[xy] = pt
        return MsmExpr.base(self, pt)

    def msm_base_proj(self, pt):
        """pt: (B, 3, 8) or (3, 8) projective words."""
        return MsmExpr.base(self, pt)

    def msm_constant(self, s):
        return MsmExpr.constant(self, s)

    def msm_sum(self, exprs: List):
        return MsmExpr.sum(self, exprs)

    def msm_is_identity(self, expr):
        """(B,) bool: the MSM (no constant term) is the identity."""
        return cuda_ops.is_identity(self.msm_evaluate(expr, None))

    def affine(self, pt):
        """(B, 3, 8) -> (B, 2, 8) affine words, the identity as (0, 0): one
        `svt_field_inv` and one `svt_field_mul` launch on the card."""
        return cuda_ops.affine_xy(pt.expand(self.batch, 3, 8).contiguous())

    def msm_evaluate(self, expr, g=None):
        """-> (B, 3, 8): the scaled terms' scalars out of Montgomery form in
        one batched `from_mont`, then `msm_expr.lower`."""
        scaled, plain = expr.terms(g)
        B = self.batch
        pts = scs = None
        if scaled:
            pts = torch.stack([p.expand(B, 3, 8) for _, p in scaled], 1)  # (B, n, 3, 8)
            scs = FRW.from_mont(torch.stack([s.expand(B, 8) for s, _ in scaled], 1))
        return lower(pts, scs, plain, B, self.device)

    def accumulator_from_limbs(self, limbs: List):
        """12 limb handles -> (lhs, rhs), each (B, 3, 8): the device decode."""
        return accumulator_from_limbs([l.expand(self.batch, 8) for l in limbs])

    # -------------------------------------------------------------- decide

    def decide_all(self, srs, accumulators: List):
        """(B,) bool: every accumulator of a lane passes its pairing check.
        Kept so that the loader offers the whole interface of the JAX
        package's `DeviceLoader` to code written against it;
        `parallel.batch_verify` calls the decider directly.  The import is
        local, as there: the decider is a layer above the loader."""
        from ..pcs.kzg.decider import decide_all

        return decide_all(srs, accumulators).all(dim=0)


# -------------------------------------------------------------- the oracle


class NativeMsm:
    """Lazy `constant·g + Σ scalarᵢ·baseᵢ` over python ints / py_ec points."""

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
        acc = None
        for s, p in self.pairs:
            acc = py_ec.add(acc, p if s is None else py_ec.scalar_mul(p, s))
        if self.const is not None:
            if g is None:
                raise ValueError("the constant term needs the generator")
            acc = py_ec.add(acc, py_ec.scalar_mul(g, self.const))
        return acc


class NativeLoader:
    """Python-int oracle execution (the reference's NativeLoader)."""

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
        """Montgomery's trick, 0 -> 0 (the device batch_inv's contract)."""
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

    def load_svk(self, srs):
        return srs.g

    def decide_all(self, srs, accumulators: List) -> bool:
        """e(lhs, g2)·e(rhs, −s_g2) == 1 for every accumulator, by the
        python-int pairing (the reference's decider.rs:60-80)."""
        from ..pairing import py_pairing as pp

        neg_s_g2 = pp.g2_neg(srs.s_g2)
        return all(pp.pairing_check([(lhs, srs.g2), (rhs, neg_s_g2)])
                   for lhs, rhs in accumulators)


NATIVE = NativeLoader()
