"""A recorded Fr program and its two runners: the port's counterpart of the
one XLA program the JAX package compiles for the succinct verifier's scalar
algebra (`parallel/batch_verify.py:86-108`, which traces the verifier into
one `jax.jit` and lets XLA fuse `ff/jnp_field.py::LimbField`'s `mul` :145,
`batch_inv` :236 and `pow_static` :200).

The verifier's Fr work is lane-wise and the same for every proof of a
protocol, so it is recorded once (`loader/tape_loader.py`) and replayed for
a whole batch:

  * `FrTape` holds the rows (op, dst, src1, src2) as an (n, 4) int32 array,
    a constant table of (n_const, 8) Montgomery words, the list of inputs
    and the list of outputs;
  * `assemble` turns a recorder's SSA ops into a tape: dead ops dropped,
    slots assigned by a linear scan over last uses (so the live set, not
    the op count, sets the slot count), constants deduplicated;
  * `run_plain` interprets the rows on any device through `FRW.plain` (the
    `LimbField` ops): the plain version of the kernel;
  * `run` launches `svt_fr_tape` (csrc/fr_tape.cu), the whole tape for
    every lane in one launch, on a CUDA tensor, and raises on a CPU one.

Ops (the semantics of csrc/field_kernels.cu and `WordField`, lazy [0, 2p]
in and out): MUL, ADD, SUB, NEG, INV, CANON; ONE_IF_ZERO ("1 where
canon(a) = 0, else a") and ZERO_IF_ZERO ("0 where canon(a) = 0, else x"),
the two selects of `WordField.batch_inv`; OUT writes `from_mont` of its
operand (the product by plain 1, then CANON) as a canonical plain word to
output row dst.  An operand is `kind << 24 | index`: a slot, an input row
or a constant.
"""

from __future__ import annotations

import functools
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import errors
from .._build import load_library
from .._launch import check, launch
from ..device import device_key
from .spec import FR, int_to_limbs
from .word_field import FRW, np_limbs_to_words

MUL, ADD, SUB, NEG, INV, CANON, ONE_IF_ZERO, ZERO_IF_ZERO, OUT = range(9)
OP_NAMES = ("mul", "add", "sub", "neg", "inv", "canon", "one_if_zero", "zero_if_zero", "out")
BINARY = {MUL, ADD, SUB, ZERO_IF_ZERO}
SLOT, INPUT, CONST = range(3)  # operand kinds
KIND_SHIFT = 24
INDEX_MASK = (1 << KIND_SHIFT) - 1
# The slot file lives in shared memory, 1 KB a slot for a block of 32 lanes:
# the 227 KB a block may use on an H100 hold 227 slots.
MAX_SLOTS = 227
# Multiplies of one INV as the kernel runs it (fe_inv, Fermat): 254
# squarings and popcount(r - 2) products.
INV_MULS = 254 + bin(FR.p - 2).count("1")
# 32-bit multiply-adds of one Fr operation on a lane (8 words, Montgomery):
# a product 64 for a·b, 8 for the quotients, 64 for m·p; a square's a·a
# takes 36; a reduction alone (from_mont) 8 + 64.
MULADDS_MUL, MULADDS_SQR, MULADDS_REDUCE = 136, 108, 72


def window_chain(e: int, w: int) -> Tuple[List[Tuple[int, int]], int]:
    """A left-to-right sliding-window addition chain for x^e (e > 0) with
    windows of up to w bits: (steps, result).  Value 0 is x and step k,
    (a, b), makes value k + 1 = value a · value b (a square where a == b)."""
    steps: List[Tuple[int, int]] = []

    def op(a, b):
        steps.append((a, b))
        return len(steps)

    odd = [0]  # x, x^3, ..., x^(2^w - 1)
    if w > 1:
        x2 = op(0, 0)
        for _ in range((1 << (w - 1)) - 1):
            odd.append(op(odd[-1], x2))
    bits, acc, i = bin(e)[2:], None, 0
    while i < len(bits):
        if bits[i] == "0":
            acc, i = op(acc, acc), i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        t = odd[int(bits[i:j], 2) >> 1]
        if acc is None:
            acc = t
        else:
            for _ in range(j - i):
                acc = op(acc, acc)
            acc = op(acc, t)
        i = j
    return steps, acc


def chain_muladds(steps: Sequence[Tuple[int, int]]) -> int:
    return sum(MULADDS_SQR if a == b else MULADDS_MUL for a, b in steps)


@functools.lru_cache(maxsize=None)
def inv_least_muladds() -> int:
    """Multiply-adds of the least-cost sliding-window chain for x^(r - 2)
    over window widths 1..8: the work an inversion needs (~60 products
    beside the squarings, where Fermat's square-and-multiply takes 127)."""
    return min(chain_muladds(window_chain(FR.p - 2, w)[0]) for w in range(1, 9))


Ref = Tuple[str, int]  # ("v", op index) | ("in", input index) | ("c", canonical value)


@dataclass
class FrTape:
    rows: np.ndarray  # (n, 4) int32: op, dst, src1, src2
    consts: np.ndarray  # (max(n_const, 1), 8) int32 Montgomery words
    inputs: List  # one label per input row
    outputs: List  # one label per output row
    n_slots: int
    _dev: Dict = field(default_factory=dict, repr=False, compare=False)

    def op_counts(self) -> Dict[str, int]:
        ops, n = np.unique(self.rows[:, 0], return_counts=True)
        return {OP_NAMES[o]: int(c) for o, c in zip(ops, n)}

    def muls(self) -> int:
        """Fr multiplies one lane runs: MUL and OUT one each, INV 254
        squarings and popcount(r - 2) products."""
        c = self.op_counts()
        return c.get("mul", 0) + c.get("out", 0) + INV_MULS * c.get("inv", 0)

    def chain_muls(self) -> int:
        """The longest dependent chain of multiplies through the rows."""
        w = {MUL: 1, OUT: 1, INV: INV_MULS}
        return self.chain([w.get(op, 0) for op in self.rows[:, 0].tolist()])

    def row_muladds(self, least=False) -> np.ndarray:
        """32-bit multiply-adds of each row on one lane: as the kernel runs
        it (a square where both operands are one value, OUT a full product,
        INV Fermat's square-and-multiply), or with `least` the least the
        row's function needs (OUT a reduction, INV `inv_least_muladds`)."""
        op, s1, s2 = self.rows[:, 0], self.rows[:, 2], self.rows[:, 3]
        w = np.zeros(len(op), np.int64)
        w[op == MUL] = MULADDS_MUL
        w[(op == MUL) & (s1 == s2)] = MULADDS_SQR
        w[op == OUT] = MULADDS_REDUCE if least else MULADDS_MUL
        w[op == INV] = (inv_least_muladds() if least
                        else 254 * MULADDS_SQR + (INV_MULS - 254) * MULADDS_MUL)
        return w

    def chain(self, weights) -> int:
        """The longest dependent chain through the rows, row i weighing
        weights[i]: the chain floor's count.  The kernel runs every row in
        sequence, so a lane's time follows the sum, not this."""
        depth = np.zeros(self.n_slots, np.int64)
        best = 0
        for (op, dst, s1, s2), wi in zip(self.rows.tolist(), weights):
            d = 0
            for s in ((s1, s2) if op in BINARY else (s1,)):
                if s >> KIND_SHIFT == SLOT:
                    d = max(d, int(depth[s & INDEX_MASK]))
            d += int(wi)
            best = max(best, d)
            if op != OUT:
                depth[dst] = d
        return best

    def device_arrays(self, device):
        """(rows, consts) as int32 tensors on `device`, uploaded once."""
        key = device_key(device)
        if key not in self._dev:
            self._dev[key] = (torch.from_numpy(self.rows).to(device),
                              torch.from_numpy(self.consts).to(device))
        return self._dev[key]


def _mont_words(values: Sequence[int]) -> np.ndarray:
    R = 1 << 256
    if not values:
        return np.zeros((1, 8), np.int32)
    return np_limbs_to_words(np.stack([int_to_limbs(v * R % FR.p) for v in values]))


def assemble(ops: Sequence[Tuple[int, Ref, Ref, int]], inputs: List, outputs: List) -> FrTape:
    """A recorder's ops -> FrTape.  ops[k] = (op, a, b, dst): a and b are
    operand refs (b None for a unary op), dst the output row of an OUT and
    None otherwise; op k defines value ("v", k).  Ops no output depends on
    are dropped.  Raises errors.InvalidProtocol when the live set needs more
    slots than a block's shared memory holds."""
    live = [False] * len(ops)
    needed = set()
    for k in range(len(ops) - 1, -1, -1):
        op, a, b, _ = ops[k]
        if op == OUT or k in needed:
            live[k] = True
            for r in (a, b):
                if r is not None and r[0] == "v":
                    needed.add(r[1])
    last_use: Dict[int, int] = {}
    for k, (op, a, b, _) in enumerate(ops):
        if live[k]:
            for r in (a, b):
                if r is not None and r[0] == "v":
                    last_use[r[1]] = k

    consts: Dict[int, int] = {}
    slot_of: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0

    def operand(r: Ref) -> int:
        if r[0] == "v":
            return (SLOT << KIND_SHIFT) | slot_of[r[1]]
        if r[0] == "in":
            return (INPUT << KIND_SHIFT) | r[1]
        return (CONST << KIND_SHIFT) | consts.setdefault(r[1], len(consts))

    rows = []
    for k, (op, a, b, dst) in enumerate(ops):
        if not live[k]:
            continue
        s1 = operand(a)
        s2 = operand(b) if b is not None else 0
        for r in {a, b}:  # slots whose value dies here are free for this op's result
            if r is not None and r[0] == "v" and last_use[r[1]] == k:
                heapq.heappush(free, slot_of.pop(r[1]))
        if op != OUT:
            if free:
                slot = heapq.heappop(free)
            else:
                slot, n_slots = n_slots, n_slots + 1
            slot_of[k] = dst = slot
        rows.append((op, dst, s1, s2))
    if n_slots > MAX_SLOTS:
        raise errors.InvalidProtocol(
            f"the Fr program keeps {n_slots} values live; the kernel's slot file holds {MAX_SLOTS}")
    order = sorted(consts, key=consts.get)
    return FrTape(rows=np.array(rows, np.int32).reshape(-1, 4), consts=_mont_words(order),
                  inputs=list(inputs), outputs=list(outputs), n_slots=max(n_slots, 1))


def _check_inputs(tape: FrTape, inputs):
    check("fr_tape", inputs, 3, (8,))
    if inputs.shape[0] != len(tape.inputs):
        raise ValueError(f"fr_tape: {inputs.shape[0]} input rows, the tape reads {len(tape.inputs)}")


def run_plain(tape: FrTape, inputs):
    """The plain version of `svt_fr_tape` on any device: inputs (n_in, B, 8)
    Fr Montgomery words -> (n_out, B, 8) canonical plain words, each row
    through `FRW.plain` (the `LimbField` op on the repacked limbs)."""
    _check_inputs(tape, inputs)
    dev, B = inputs.device, inputs.shape[1]
    _, consts = tape.device_arrays(dev)
    one, one_plain = FRW.const("ONE", dev), FRW.const("ONE_PLAIN", dev)
    slots: List = [None] * tape.n_slots
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=dev)

    def fetch(code):
        kind, idx = code >> KIND_SHIFT, code & INDEX_MASK
        return slots[idx] if kind == SLOT else inputs[idx] if kind == INPUT else consts[idx]

    def is_zero(a):
        return (FRW.plain("canon", a) == 0).all(-1, keepdim=True)

    for op, dst, s1, s2 in tape.rows.tolist():
        a = fetch(s1)
        if op == OUT:
            out[dst] = FRW.plain("canon", FRW.plain("mul", a, one_plain)).expand(B, 8)
            continue
        if op == ONE_IF_ZERO:
            r = torch.where(is_zero(a), one, a)
        elif op == ZERO_IF_ZERO:
            r = torch.where(is_zero(a), torch.zeros_like(one), fetch(s2))
        elif op in BINARY:
            r = FRW.plain(OP_NAMES[op], a, fetch(s2))
        else:
            r = FRW.plain(OP_NAMES[op], a)
        slots[dst] = r
    return out


def run(tape: FrTape, inputs):
    """One launch of `svt_fr_tape`: inputs (n_in, B, 8) Fr Montgomery words
    on a CUDA card -> (n_out, B, 8) canonical plain words.  Raises on a CPU
    tensor: `run_plain` is the plain version, and the caller picks it."""
    _check_inputs(tape, inputs)
    if inputs.device.type != "cuda":
        raise ValueError("fr_tape.run launches svt_fr_tape and needs a CUDA tensor; "
                         "run_plain is the plain version")
    rows, consts = tape.device_arrays(inputs.device)
    B = inputs.shape[1]
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=inputs.device)
    if B and len(tape.rows):
        launch("fr_tape", load_library().svt_fr_tape, rows.data_ptr(), len(tape.rows),
               consts.data_ptr(), inputs.data_ptr(), out.data_ptr(), B, tape.n_slots,
               device=inputs.device)
    return out
