"""TapeLoader: the recording loader.  It offers the loader interface of
`loader/base.py` to the verifier, but its handles are symbols and its field
ops append rows to an Fr program (`ff/fr_tape.py`) instead of running: the
port's counterpart of tracing the succinct verifier into one `jax.jit`
program (the JAX package's `parallel/batch_verify.py:86-108`).

  * `input(label)` makes an input symbol, `scalar(v)` a constant; ops on
    constants alone fold on the host;
  * add / sub / mul / neg append one row each; `batch_inv`, `pow_static`
    and `powers` record the same sequence of ops as `WordField.batch_inv`,
    `pow_static` and `powers` (`ff/word_field.py`);
  * msm_base / msm_base_int / msm_base_proj / msm_constant build
    `MsmExpr`s over symbols and base sources: ("stream", j), the proof's
    j-th point; ("const", k), the k-th protocol point; ("lane", k), the
    k-th lane point, a (B, 3, 8) projective point of every lane handed in
    at run time (`lane_point`: an IPA commitment or accumulator); ("g",),
    the generator;
  * `msm_evaluate` with the generator records one output (an OUT row: the
    scalar's canonical plain word) per scaled term, in `MsmExpr.terms`'
    order, and returns an `MsmRecord` of output rows and base sources;
    without it, the MSM is one the plan computes before the tape runs (the
    commitment to the instances of an instance-committing-key protocol:
    instance inputs times protocol points), and its value is a new lane
    point; `msm_is_identity` records the MSM and returns an
    `IdentityRecord`, the plan's accept bit;
  * `affine` passes a lane point on: the transcript absorbs it as a lane
    point;
  * `accumulator_from_limbs` records nothing on the tape: it returns a
    `LimbRecord` of the 12 instance inputs that hold an old accumulator,
    which the plan decodes on the device per batch.

What it cannot record raises `errors.InvalidProtocol` naming what it met:
a symbol's value read on the host, a handle of another loader, the decide.
Nothing runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .. import errors
from ..ff import fr_tape as ft
from ..ff.spec import FR
from .msm_expr import MsmExpr

GENERATOR = ("g",)  # the base source of the generator


class Sym:
    """A recorded Fr value: ("v", op index), ("in", input index) or ("c",
    canonical value).  It has no value on the host."""

    __slots__ = ("ref",)

    def __init__(self, ref):
        self.ref = ref

    def _refuse(self, *_args, **_kw):
        raise errors.InvalidProtocol(
            f"the recorder met a read of the symbol {self.ref} on the host; "
            "the verifier's Fr work must go through the loader")

    __bool__ = __int__ = __index__ = __float__ = __len__ = __iter__ = _refuse
    __array__ = __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __neg__ = _refuse
    __eq__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __hash__ = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise errors.InvalidProtocol(f"the recorder met torch.{getattr(func, '__name__', func)} "
                                     "on a symbol")

    def __repr__(self):
        return f"Sym{self.ref}"


class StreamPoint:
    """The proof's j-th point, as the transcript reads it."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class LanePoint:
    """The k-th lane point: a projective point of every lane that the plan
    hands in at run time, (B, 3, 8) words."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


@dataclass
class MsmRecord:
    """One lowered MSM: scaled terms (output row, base source) and the
    coefficient-1 base sources, in `MsmExpr.terms`' order."""

    scaled: List[Tuple[int, tuple]]
    plain: List[tuple]


@dataclass
class IdentityRecord:
    """An accept bit: the MSM of `msm` is the identity."""

    msm: MsmRecord


@dataclass
class LaneCommitment:
    """A lane point the plan computes before the tape: Σ input·protocol
    point over `scaled` (input row, const index) plus the coefficient-1
    protocol points `plain`."""

    scaled: List[Tuple[int, int]]
    plain: List[int]


@dataclass
class LimbRecord:
    """An instance-encoded old accumulator: the tape's input rows of its 12
    limbs (`pcs/kzg/accumulator.py`)."""

    inputs: List[int]


_FOLD = {
    ft.MUL: lambda a, b: a * b,
    ft.ADD: lambda a, b: a + b,
    ft.SUB: lambda a, b: a - b,
    ft.NEG: lambda a, b: -a,
    ft.INV: lambda a, b: pow(a, FR.p - 2, FR.p),
    ft.CANON: lambda a, b: a,
    ft.ONE_IF_ZERO: lambda a, b: a if a else 1,
    ft.ZERO_IF_ZERO: lambda a, b: b if a else 0,
}


class TapeLoader:
    """Records the Fr program of one verifier run; `finish` assembles it."""

    def __init__(self):
        self.ops: List = []  # (op, a ref, b ref | None, output row | None)
        self.inputs: List = []
        self.outputs: List = []
        self.const_points: List = []  # host affine points, by ("const", k)
        self.lane_points: List = []  # by ("lane", k): None (handed in) or a LaneCommitment

    # ------------------------------------------------------------- scalars

    def input(self, label) -> Sym:
        self.inputs.append(label)
        return Sym(("in", len(self.inputs) - 1))

    def scalar(self, v: int) -> Sym:
        return Sym(("c", int(v) % FR.p))

    def zero_scalar(self) -> Sym:
        return self.scalar(0)

    def _ref(self, what: str, x):
        if not isinstance(x, Sym):
            raise errors.InvalidProtocol(f"the recorder cannot take a {type(x).__name__} "
                                         f"as an operand of {what}")
        return x.ref

    def _op(self, op: int, a, b=None) -> Sym:
        ra = self._ref(ft.OP_NAMES[op], a)
        rb = None if b is None else self._ref(ft.OP_NAMES[op], b)
        if ra[0] == "c" and (rb is None or rb[0] == "c"):
            return self.scalar(_FOLD[op](ra[1], None if rb is None else rb[1]))
        self.ops.append((op, ra, rb, None))
        return Sym(("v", len(self.ops) - 1))

    def add(self, a, b):
        return self._op(ft.ADD, a, b)

    def sub(self, a, b):
        return self._op(ft.SUB, a, b)

    def mul(self, a, b):
        return self._op(ft.MUL, a, b)

    def neg(self, a):
        return self._op(ft.NEG, a)

    def batch_inv(self, xs: List) -> List:
        """`WordField.batch_inv`'s sequence: zeros replaced by 1, prefix
        products, one inverse, carries down the chain, one product per
        element, zeros mapped back to 0."""
        one = self.scalar(1)
        safe = [self._op(ft.ONE_IF_ZERO, x) for x in xs]
        prefix = [safe[0]]
        for s in safe[1:]:
            prefix.append(self.mul(prefix[-1], s))
        carry = [self._op(ft.INV, prefix[-1])]
        for i in range(len(xs) - 1, 0, -1):
            carry.append(self.mul(carry[-1], safe[i]))
        out = [self.mul(c, p) for c, p in zip(carry[::-1], [one] + prefix[:-1])]
        return [self._op(ft.ZERO_IF_ZERO, x, o) for x, o in zip(xs, out)]

    def pow_static(self, a, e: int):
        if e == 0:
            return self.scalar(1)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def powers(self, x, n: int) -> List:
        out = [self.scalar(1)]
        for _ in range(n - 1):
            out.append(self.mul(out[-1], x))
        return out

    # ----------------------------------------------------------------- msm

    def msm_zero(self):
        return MsmExpr(self)

    def msm_base(self, xy):
        if not isinstance(xy, StreamPoint):
            raise errors.InvalidProtocol(f"the recorder cannot take a {type(xy).__name__} "
                                         "as a proof point")
        return MsmExpr.base(self, ("stream", xy.index))

    def msm_base_int(self, xy):
        """A protocol point: its index in `const_points`."""
        xy = tuple(xy)
        if xy not in self.const_points:
            self.const_points.append(xy)
        return MsmExpr.base(self, ("const", self.const_points.index(xy)))

    def lane_point(self) -> LanePoint:
        """A new lane point, handed in at run time."""
        self.lane_points.append(None)
        return LanePoint(len(self.lane_points) - 1)

    def msm_base_proj(self, pt):
        if not isinstance(pt, LanePoint):
            raise errors.InvalidProtocol(f"the recorder cannot take a {type(pt).__name__} "
                                         "as a lane point")
        return MsmExpr.base(self, ("lane", pt.index))

    def msm_constant(self, s):
        return MsmExpr.constant(self, s)

    def msm_sum(self, exprs: List):
        return MsmExpr.sum(self, exprs)

    def msm_evaluate(self, expr, g=None):
        """With the generator -> an MsmRecord; without it -> the LanePoint
        of a commitment the plan computes before the tape (see the module
        docstring)."""
        if g is None:
            return self._lane_commitment(expr)
        if g is not GENERATOR:
            raise errors.InvalidProtocol("the recorder takes the generator as tape_loader.GENERATOR")
        scaled, plain = expr.terms(GENERATOR)
        return MsmRecord([(self.output(s, "msm"), base) for s, base in scaled], plain)

    def _lane_commitment(self, expr) -> LanePoint:
        if expr.const is not None:
            raise errors.InvalidProtocol("a commitment before the tape has no generator term")
        scaled, plain = [], []
        for s, base in expr.pairs:
            if base[0] != "const" or (s is not None and s.ref[0] != "in"):
                raise errors.InvalidProtocol(
                    "a commitment before the tape takes instance inputs times protocol "
                    f"points, not {s} times {base}")
            if s is None:
                plain.append(base[1])
            else:
                scaled.append((s.ref[1], base[1]))
        self.lane_points.append(LaneCommitment(scaled, plain))
        return LanePoint(len(self.lane_points) - 1)

    def msm_is_identity(self, expr) -> IdentityRecord:
        return IdentityRecord(self.msm_evaluate(expr, GENERATOR))

    def affine(self, pt):
        if not isinstance(pt, LanePoint):
            raise errors.InvalidProtocol(f"the recorder cannot normalise a {type(pt).__name__}")
        return pt

    def accumulator_from_limbs(self, limbs: List) -> LimbRecord:
        rows = []
        for limb in limbs:
            ref = self._ref("accumulator_from_limbs", limb)
            if ref[0] != "in":
                raise errors.InvalidProtocol("the recorder decodes accumulators from instance "
                                             f"inputs only, not {ref}")
            rows.append(ref[1])
        return LimbRecord(rows)

    def output(self, s, label) -> int:
        """Record an output row: s as a canonical plain word.  -> its index."""
        self.ops.append((ft.OUT, self._ref("out", s), None, len(self.outputs)))
        self.outputs.append(label)
        return len(self.outputs) - 1

    def decide_all(self, srs, accumulators):
        raise errors.InvalidProtocol("the recorder cannot record the pairing decide")

    # ------------------------------------------------------------ assemble

    def finish(self) -> ft.FrTape:
        return ft.assemble(self.ops, self.inputs, self.outputs)


class TapeTranscript:
    """The transcript interface that owns the order of a tape's transcript
    inputs, the same object recording and running, so the two cannot
    diverge.  Each squeezed challenge and read scalar is labelled
    (kind, index) in `labels`, in read order: the labels of the tape's
    inputs after the instances.

      * recording (`inner` None): each read is a new input symbol of `L`,
        the j-th point read is StreamPoint(j), and the real transcript runs
        before the tape, on the card.  What the transcript would hash is
        kept as `squeezes`: squeeze q's buffer as word sources, ("const",
        v), ("input", label) for an absorbed input symbol, ("scalar", j)
        and ("point", j) for the j-th stream read, ("lane", k) for lane
        point k, ("hash", q') for an earlier squeeze's output, ("value",
        ref) for anything else (which no read schedule takes:
        `verifier/plonk/plan.py`);
      * running (`inner` a real transcript): every call passes on to it, and
        `values` keeps each labelled read's value."""

    def __init__(self, L: TapeLoader = None, inner=None):
        if (L is None) == (inner is None):
            raise ValueError("TapeTranscript records into a TapeLoader or runs a transcript")
        self.L, self.inner = L, inner
        self.labels: List[tuple] = []
        self.values: List = []
        self.n_points = 0
        self.n_scalars = 0
        self.squeezes: List[List[tuple]] = []
        self._buf: List[tuple] = []

    def _source(self, s) -> tuple:
        ref = s.ref if isinstance(s, Sym) else None
        if ref is not None and ref[0] == "c":
            return ("const", ref[1])
        if ref is not None and ref[0] == "in":
            return ("input", self.L.inputs[ref[1]])
        return ("value", ref)

    def common_scalar(self, s):
        if self.inner is not None:
            self.inner.common_scalar(s)
        else:
            self._buf.append(self._source(s))

    def common_ec_point(self, pt):
        """A lane point is absorbed through the inner transcript's
        `common_lane_point` (its affine form, mapped Fq -> Fr once for all
        the lane points)."""
        if self.inner is not None and isinstance(pt, LanePoint):
            self.inner.common_lane_point(pt.index)
        elif self.inner is not None:
            self.inner.common_ec_point(pt)
        elif isinstance(pt, (StreamPoint, LanePoint)):
            self._buf.append(("point" if isinstance(pt, StreamPoint) else "lane", pt.index))
        else:
            self._buf.append(("value", None))

    def _read(self, kind: str, method: str):
        label = (kind, len(self.labels))
        self.labels.append(label)
        v = self.L.input(label) if self.inner is None else getattr(self.inner, method)()
        self.values.append(v)
        return v

    def squeeze_challenge(self):
        if self.inner is None:
            self.squeezes.append(self._buf)
            self._buf = [("hash", len(self.squeezes) - 1)]
        return self._read("challenge", "squeeze_challenge")

    def read_scalar(self):
        if self.inner is None:
            self._buf.append(("scalar", self.n_scalars))
        self.n_scalars += 1
        return self._read("scalar", "read_scalar")

    def read_n_scalars(self, n: int) -> List:
        return [self.read_scalar() for _ in range(n)]

    def read_ec_point(self):
        self.n_points += 1
        if self.inner is not None:
            return self.inner.read_ec_point()
        self._buf.append(("point", self.n_points - 1))
        return StreamPoint(self.n_points - 1)

    def read_n_ec_points(self, n: int) -> List:
        return [self.read_ec_point() for _ in range(n)]
