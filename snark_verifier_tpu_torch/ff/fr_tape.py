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
  * `schedule` turns a tape into a team schedule for `svt_fr_tape`: steps
    of up to T independent rows of one op class, one row a thread of a
    team of T, slots assigned anew (`FrTape.schedule` caches it);
  * `run_plain` interprets the rows on any device through `FRW.plain` (the
    `LimbField` ops): the plain version of the kernel;
  * `run` launches `svt_fr_tape` (csrc/fr_tape.cu), the whole schedule for
    every lane in one launch, on a CUDA tensor, and raises on a CPU one.

Ops (the semantics of csrc/field_kernels.cu and `WordField`, lazy [0, 2p]
in and out): MUL, ADD, SUB, NEG, INV, CANON; ONE_IF_ZERO ("1 where
canon(a) = 0, else a") and ZERO_IF_ZERO ("0 where canon(a) = 0, else x"),
the two selects of `WordField.batch_inv`; OUT writes `from_mont` of its
operand (the product by plain 1, then CANON) as a canonical plain word to
output row dst.  INV is the canonical inverse, A R -> A^-1 R in [0, p) and
0 -> 0: the word `csrc/fe_inv.cuh::fe_inv_gcd` returns, and in `run_plain`
the plain Fermat inverse (`LimbField.inv`, lazy) after `canon`, so kernel
and twin agree on every value.  An operand is `kind << 24 | index`: a
slot, an input row or a constant.
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
NOP = 9  # an empty place of a schedule's step
OP_NAMES = ("mul", "add", "sub", "neg", "inv", "canon", "one_if_zero", "zero_if_zero", "out")
BINARY = {MUL, ADD, SUB, ZERO_IF_ZERO}
SLOT, INPUT, CONST = range(3)  # operand kinds
KIND_SHIFT = 24
INDEX_MASK = (1 << KIND_SHIFT) - 1
# The slot file lives in shared memory, 32 B a slot and lane: 1 KB a slot
# for the 32 lanes a one-warp block holds at T = 1, so the 227 KB a block
# may use on an H100 hold 227 slots (227 T at T, the block holding 32 / T
# lanes).
MAX_SLOTS = 227
# Team sizes of svt_fr_tape: a team of T threads of one warp runs a lane.
TEAMS = (1, 2, 4, 8)
# The team `run` takes, whatever the batch: the largest.  A lane's time is
# its schedule's steps (109 at T = 8 for vanilla PLONK k=10, 594 at T = 1),
# and at the paths' batches (1 to 1,024 lanes, 8 threads a lane: at most
# 8,192 threads) the card has room for every team.  Measured the fastest
# at every path's shape, SHPLONK, GWC19, IPA k = 11 and ick keccak at B =
# 1,024 and SHPLONK at B = 1 (PERF.md §6, PR 19).
TEAM = 8
# The op classes a step holds one of, so that a warp runs one branch at a
# time: products (MUL of two values, OUT's product by plain 1), squares,
# inversions, and the cheap rows (ADD, SUB, NEG, CANON, the two selects).
PRODUCT, SQUARE, INVERT, CHEAP = range(4)
CLASS_NAMES = ("product", "square", "invert", "cheap")
# A row's clocks by class for a warp alone, the list scheduler's weights:
# a Montgomery product ~800 (PERF.md), a square ~700, the binary GCD's
# ~13 rounds of ~1,200 clocks, a cheap row's fetch, op and store ~100.
CLASS_CLOCKS = (800, 700, 16_000, 100)
# Multiplies of one INV as the reference runs it (LimbField.inv, Fermat):
# 254 squarings and popcount(r - 2) products.  svt_fr_tape runs the binary
# GCD instead (fe_inv.cuh), whose rounds depend on the value.
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
    _schedules: Dict = field(default_factory=dict, repr=False, compare=False)

    def op_counts(self) -> Dict[str, int]:
        ops, n = np.unique(self.rows[:, 0], return_counts=True)
        return {OP_NAMES[o]: int(c) for o, c in zip(ops, n)}

    def muls(self) -> int:
        """Fr multiplies one lane runs in the reference's terms: MUL and
        OUT one each, INV Fermat's 254 squarings and popcount(r - 2)
        products (the kernel's INV is the binary GCD, no multiplies)."""
        c = self.op_counts()
        return c.get("mul", 0) + c.get("out", 0) + INV_MULS * c.get("inv", 0)

    def chain_muls(self) -> int:
        """The longest dependent chain of multiplies through the rows, an
        INV counted as Fermat's (the reference's count)."""
        w = {MUL: 1, OUT: 1, INV: INV_MULS}
        return self.chain([w.get(op, 0) for op in self.rows[:, 0].tolist()])

    def schedule(self, team: int) -> "Schedule":
        """The team schedule of `schedule(self, team)`, made once."""
        if team not in self._schedules:
            self._schedules[team] = schedule(self, team)
        return self._schedules[team]

    def row_muladds(self, least=False) -> np.ndarray:
        """32-bit multiply-adds of each row on one lane: as the reference
        runs it (a square where both operands are one value, OUT a full
        product, INV Fermat's square-and-multiply), or with `least` the
        least the row's function needs (OUT a reduction, INV
        `inv_least_muladds`)."""
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
        weights[i]: the chain floor's count.  A team schedule runs a step's
        rows side by side, so a lane's time follows the steps' sum."""
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


@dataclass
class Schedule:
    """A tape as svt_fr_tape runs it: step k holds up to `team` rows of one
    op class, thread r of a team running place r, a warp barrier between
    steps.  The rows name the schedule's own slots."""

    team: int
    steps: np.ndarray  # (n_steps, team, 4) int32 rows; op NOP where a step is short
    order: np.ndarray  # (n_steps, team) the tape row at each place, -1 where NOP
    classes: np.ndarray  # (n_steps,) each step's op class
    n_slots: int
    _dev: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def counts(self) -> Dict[str, int]:
        """Steps in all and by op class."""
        n = np.bincount(self.classes, minlength=len(CLASS_NAMES))
        return {"steps": self.n_steps, **{f"{c}_steps": int(k) for c, k in zip(CLASS_NAMES, n)}}

    def device_steps(self, device):
        """The steps as an int32 tensor on `device`, uploaded once."""
        key = device_key(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(np.ascontiguousarray(self.steps)).to(device)
        return self._dev[key]


def row_class(op: int, s1: int, s2: int) -> int:
    if op == MUL:
        return SQUARE if s1 == s2 else PRODUCT
    return PRODUCT if op == OUT else INVERT if op == INV else CHEAP


def _operands(op, s1, s2):
    return (s1, s2) if op in BINARY else (s1,)


def _reach(succ: List[List[int]], i: int) -> set:
    """The rows that depend on row i, directly or not."""
    seen, todo = set(), [i]
    while todo:
        for s in succ[todo.pop()]:
            if s not in seen:
                seen.add(s)
                todo.append(s)
    return seen


def schedule(tape: FrTape, team: int) -> Schedule:
    """The team schedule of `tape` for teams of `team` threads (one of
    TEAMS).  team = 1 is the tape in order, a row a step.  Otherwise a list
    scheduler over the rows' dependences: each step takes the op class of
    the ready row with the longest weighted path to the tape's end
    (CLASS_CLOCKS), then up to `team` ready rows of that class, longest
    path first; a row is ready the step after its last operand's.  An INV
    waits, while other rows are ready, for an INV that neither precedes
    nor follows it, so that the two share a step.  Slots are assigned
    anew: a step's results take the lowest free slots, and a slot is free
    from the step after its last reader's, so no row writes a slot that a
    row of its step reads.  Raises errors.InvalidProtocol when a row reads
    a slot no earlier row wrote, or when the slots, the inputs and the
    constants (the kernel holds all three) exceed the slot file (MAX_SLOTS
    · team)."""
    if team not in TEAMS:
        raise ValueError(f"fr_tape: team {team}, not one of {TEAMS}")
    rows = tape.rows.tolist()
    n = len(rows)
    writer: Dict[int, int] = {}
    srcs: List[List[int]] = []  # the producing row of each operand, -1 if not a slot
    for i, (op, dst, s1, s2) in enumerate(rows):
        src = []
        for s in _operands(op, s1, s2):
            if s >> KIND_SHIFT != SLOT:
                src.append(-1)
            elif (s & INDEX_MASK) in writer:
                src.append(writer[s & INDEX_MASK])
            else:
                raise errors.InvalidProtocol(f"fr_tape: row {i} reads slot {s & INDEX_MASK} "
                                             f"before a row writes it")
        srcs.append(src)
        if op != OUT:
            writer[dst] = i
    cls = [row_class(op, s1, s2) for op, _, s1, s2 in rows]
    succ: List[List[int]] = [[] for _ in range(n)]
    for i, src in enumerate(srcs):
        for p in set(src) - {-1}:
            succ[p].append(i)

    if team == 1:
        steps = [[i] for i in range(n)]
    else:
        prio = [0] * n
        for i in range(n - 1, -1, -1):
            prio[i] = CLASS_CLOCKS[cls[i]] + max((prio[s] for s in succ[i]), default=0)
        invs = [i for i in range(n) if cls[i] == INVERT]
        below = {i: _reach(succ, i) for i in invs}
        partners = {i: {j for j in invs if j != i and j not in below[i] and i not in below[j]}
                    for i in invs}
        waiting = [len(set(src) - {-1}) for src in srcs]
        ready = {i for i in range(n) if waiting[i] == 0}
        done: set = set()
        steps = []
        while ready:
            held = {i for i in ready if cls[i] == INVERT
                    and any(j not in ready and j not in done for j in partners[i])}
            c = cls[max(ready - held or ready, key=lambda i: (prio[i], -i))]
            step = sorted((i for i in ready if cls[i] == c), key=lambda i: (-prio[i], i))[:team]
            steps.append(step)
            ready.difference_update(step)
            done.update(step)
            for i in step:
                for s in succ[i]:
                    waiting[s] -= 1
                    if waiting[s] == 0:
                        ready.add(s)

    step_of = [0] * n
    for k, step in enumerate(steps):
        for i in step:
            step_of[i] = k
    frees: List[List[int]] = [[] for _ in steps]  # values whose slot frees after step k
    for i in range(n):
        if rows[i][0] != OUT:
            frees[max((step_of[s] for s in succ[i]), default=step_of[i])].append(i)
    slot_of: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0
    out_steps = np.zeros((len(steps), team, 4), np.int32)
    out_steps[:, :, 0] = NOP
    order = np.full((len(steps), team), -1, np.int32)
    for k, step in enumerate(steps):
        for r, i in enumerate(step):
            op, dst, s1, s2 = rows[i]
            codes = [s if p < 0 else (SLOT << KIND_SHIFT) | slot_of[p]
                     for s, p in zip(_operands(op, s1, s2), srcs[i])]
            if op != OUT:
                if free:
                    dst = heapq.heappop(free)
                else:
                    dst, n_slots = n_slots, n_slots + 1
                slot_of[i] = dst
            out_steps[k, r] = (op, dst, codes[0], codes[1] if len(codes) > 1 else s2)
            order[k, r] = i
        for i in frees[k]:
            heapq.heappush(free, slot_of[i])
    held = len(tape.inputs) + tape.consts.shape[0]  # the kernel copies these in as slots
    if n_slots + held > MAX_SLOTS * team:
        raise errors.InvalidProtocol(
            f"the Fr program's schedule at team {team} keeps {n_slots} values live beside its "
            f"{held} inputs and constants; the kernel's slot file holds {MAX_SLOTS * team}")
    return Schedule(team=team, steps=out_steps, order=order,
                    classes=np.array([cls[s[0]] for s in steps], np.int64).reshape(-1),
                    n_slots=max(n_slots, 1))


def _check_inputs(tape: FrTape, inputs):
    check("fr_tape", inputs, 3, (8,))
    if inputs.shape[0] != len(tape.inputs):
        raise ValueError(f"fr_tape: {inputs.shape[0]} input rows, the tape reads {len(tape.inputs)}")


def plain_row(op: int, a, b, B: int):
    """One row's value from its fetched operands (b None for a unary op),
    through `FRW.plain`: OUT's canonical plain word, else the lazy word
    the row writes to its slot.  INV is Fermat's inverse after canon."""
    dev = a.device
    if op == OUT:
        return FRW.plain("canon", FRW.plain("mul", a, FRW.const("ONE_PLAIN", dev))).expand(B, 8)
    if op in (ONE_IF_ZERO, ZERO_IF_ZERO):
        one = FRW.const("ONE", dev)
        zero = (FRW.plain("canon", a) == 0).all(-1, keepdim=True)
        return torch.where(zero, one, a) if op == ONE_IF_ZERO else \
            torch.where(zero, torch.zeros_like(one), b)
    if op == INV:
        return FRW.plain("canon", FRW.plain("inv", a))
    return FRW.plain(OP_NAMES[op], a, b) if op in BINARY else FRW.plain(OP_NAMES[op], a)


def fetch_plain(code: int, slots, inputs, consts):
    """An operand's words: a slot's, an input row's or a constant's."""
    kind, idx = code >> KIND_SHIFT, code & INDEX_MASK
    return slots[idx] if kind == SLOT else inputs[idx] if kind == INPUT else consts[idx]


def run_plain(tape: FrTape, inputs, values=None):
    """The plain version of `svt_fr_tape` on any device: inputs (n_in, B, 8)
    Fr Montgomery words -> (n_out, B, 8) canonical plain words, each row
    through `FRW.plain` (the `LimbField` op on the repacked limbs), in the
    tape's order.  `values`, where given, is a list that receives every
    row's value in row order (`plain_row`)."""
    _check_inputs(tape, inputs)
    dev, B = inputs.device, inputs.shape[1]
    _, consts = tape.device_arrays(dev)
    slots: List = [None] * tape.n_slots
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=dev)
    for op, dst, s1, s2 in tape.rows.tolist():
        a = fetch_plain(s1, slots, inputs, consts)
        b = fetch_plain(s2, slots, inputs, consts) if op in BINARY else None
        r = plain_row(op, a, b, B)
        if values is not None:
            values.append(r)
        if op == OUT:
            out[dst] = r
        else:
            slots[dst] = r
    return out


def run(tape: FrTape, inputs, team=None):
    """One launch of `svt_fr_tape`: inputs (n_in, B, 8) Fr Montgomery words
    on a CUDA card -> (n_out, B, 8) canonical plain words, the tape's
    schedule run by teams of `team` threads a lane.  Where team is None the
    rule is TEAM = 8 whatever B: the largest team, measured the fastest at
    every path's shape.  Raises on a CPU tensor: `run_plain` is the plain
    version, and the caller picks it."""
    _check_inputs(tape, inputs)
    if inputs.device.type != "cuda":
        raise ValueError("fr_tape.run launches svt_fr_tape and needs a CUDA tensor; "
                         "run_plain is the plain version")
    B = inputs.shape[1]
    sched = tape.schedule(TEAM if team is None else team)
    _, consts = tape.device_arrays(inputs.device)
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=inputs.device)
    if B and len(tape.rows):
        launch("fr_tape", load_library().svt_fr_tape, sched.device_steps(inputs.device).data_ptr(),
               sched.n_steps, sched.team, consts.data_ptr(), consts.shape[0], inputs.data_ptr(),
               inputs.shape[0], out.data_ptr(), B, sched.n_slots, device=inputs.device)
    return out
