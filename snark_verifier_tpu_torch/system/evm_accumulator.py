"""The shape of snark-verifier-sdk's EVM-accumulator aggregation circuit
(`snark-verifier-sdk/configs/example_evm_accumulator.json`: degree 21,
`num_advice` [5], `num_lookup_advice` [1], `num_fixed` 1, `lookup_bits`
20, `limb_bits` 88, `num_limbs` 3) as a `vanilla_plonk.CircuitSpec`, and
witnesses of it that satisfy every gate, copy and lookup.

The circuit is built on halo2-base:

  * `FlexGateConfig`: on each of the 5 advice columns the vertical gate
    q·(a(X) + a(ωX)·a(ω²X) − a(ω³X)), its own `q_enable` selector a column
    (halo2's compression cannot merge selectors active on the same rows);
  * `RangeConfig`: one lookup-advice column looked up, without a
    selector, in a fixed table column of 2^lookup_bits rows (0, 1, ...);
  * one fixed column of constants;
  * one instance column of 12 values: the folded KZG accumulator (lhs,
    rhs) as 4 coordinates × 3 limbs of 88 bits, copied from advice cells.

Every advice column, the lookup-advice column, the constants column and
the instance column are in the permutation (8 columns).  The gate has
degree 3 and the lookup degree 4, so the quotient has 3 chunks and the
permutation 4 grand products of 2 columns each; the proof queries the
rotations {−6, −1, 0, 1, 2, 3}.

Fixed columns, in halo2's order (declared columns, then the selectors):
the constants, the lookup table, q_enable of advice 0..4.  Advice columns:
0..4 the gate's, 5 the lookup advice.

The layout (`EvmAccumulatorCircuit`) depends only on k and lookup_bits:
on advice column j a chain of gates at rows 0, 3, 6, ... (gate g's d is
gate g + 1's a); column j's first a is a copy of column j − 1's last d.
Gate g of column j holds limb 5g + j of the accumulator in b (copied to
the instance) times c = 1 (copied from the constants) for 5g + j < 12;
past that a gate is, by a fixed draw, a range gate (b a lookup value,
copied into the next row of the lookup-advice column, times c = 2^(lookup_bits·m),
copied from the constants), or a free one (b, c any field elements).
A witness (`assignment`) draws the values from its seed: the chains'
starts, the free gates' b and c, the lookup values (every unused
lookup-advice row too), and the accumulator limbs it is given.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ec import py_ec
from ..ff.spec import FR
from ..pcs.kzg.accumulator import BITS, LIMBS
from .vanilla_plonk import Assignment, CircuitSpec, Col, Lookup, compile_protocol

R = FR.p
NUM_ADVICE = 5
NUM_ACC_LIMBS = 4 * LIMBS  # lhs x, lhs y, rhs x, rhs y; 3 limbs of 88 bits each
CONSTANTS, TABLE = 0, 1  # fixed columns; q_enable of advice j is fixed column 2 + j
LOOKUP_ADVICE = NUM_ADVICE
# The instances' (column, row) pairs of the one old accumulator the proofs carry.
ACCUMULATOR_INDICES = [[(0, i) for i in range(NUM_ACC_LIMBS)]]


def evm_accumulator_spec(k: int, lookup_bits: int) -> CircuitSpec:
    """The constraint system: 7 fixed columns, 6 advice, 1 instance of 12,
    the 5 vertical gates and the one lookup."""
    if (1 << lookup_bits) > (1 << k) - 6:
        raise ValueError(f"a table of 2^{lookup_bits} rows does not fit in 2^{k} - 6 usable rows")
    adv = [Col("advice", j) for j in range(NUM_ADVICE + 1)]
    spec = CircuitSpec(k=k, num_fixed=2 + NUM_ADVICE, num_advice=[NUM_ADVICE + 1],
                       num_instance=[NUM_ACC_LIMBS],
                       permutation_columns=adv[:NUM_ADVICE] + [Col("fixed", CONSTANTS),
                                                               adv[LOOKUP_ADVICE],
                                                               Col("instance", 0)])
    spec.gates = [spec.fixed(2 + j) * (spec.advice(j) + spec.advice(j, 1) * spec.advice(j, 2)
                                       - spec.advice(j, 3))
                  for j in range(NUM_ADVICE)]
    spec.lookups = [Lookup(input_exprs=[spec.advice(LOOKUP_ADVICE)],
                           table_exprs=[spec.fixed(TABLE)])]
    return spec


@dataclass
class EvmAccumulatorCircuit:
    """The circuit's fixed part: the spec, its fixed columns, its copies,
    and each gate (`gates[column][g]`) as (kind, its lookup-advice row, the
    constants row of its c), kind "limb", "range" or "free" (rows -1 where
    the gate has none)."""

    k: int
    lookup_bits: int
    spec: CircuitSpec
    fixed: List[List[int]]
    copies: List[Tuple[Tuple[Col, int], Tuple[Col, int]]]
    gates: List[List[Tuple[str, int, int]]]

    def protocol(self, srs, device=None):
        """The compiled protocol (`vanilla_plonk.compile_protocol`), naming
        the instances as one old accumulator."""
        return compile_protocol(self.spec, self.fixed, self.copies, srs, device=device,
                                accumulator_indices=ACCUMULATOR_INDICES)

    def assignment(self, limbs: Sequence[int], seed: int) -> Assignment:
        """A witness carrying the 12 accumulator `limbs` as its instances;
        every other value drawn from `seed`."""
        if len(limbs) != NUM_ACC_LIMBS or any(not 0 <= v < 1 << BITS for v in limbs):
            raise ValueError(f"an accumulator is {NUM_ACC_LIMBS} limbs of {BITS} bits")
        rng = random.Random(f"evm_accumulator:witness:{int(seed)}")
        n, u = 1 << self.k, self.spec.usable_rows
        top = 1 << self.lookup_bits
        lookup = [rng.randrange(top) for _ in range(u)] + [0] * (n - u)
        cols = []
        start = rng.randrange(R)
        for j, gates in enumerate(self.gates):
            col = [rng.randrange(R) for _ in range(n)]  # rows past the chain are free
            a = start
            for g, (kind, lookup_row, constant_row) in enumerate(gates):
                if kind == "limb":
                    b, c = limbs[NUM_ADVICE * g + j], 1
                elif kind == "range":
                    b, c = lookup[lookup_row], self.fixed[CONSTANTS][constant_row]
                else:
                    b, c = rng.randrange(R), rng.randrange(R)
                col[3 * g:3 * g + 3] = a, b, c
                a = (a + b * c) % R
            col[3 * len(gates)] = a
            cols.append(col)
            start = a  # the next column's first a is a copy of this d
        return Assignment(spec=self.spec, fixed=self.fixed, advice_phases=[cols + [lookup]],
                          instance=[list(limbs)], copies=self.copies)


def evm_accumulator_circuit(k: int, lookup_bits: int) -> EvmAccumulatorCircuit:
    """The fixed part of the circuit at degree k with a lookup table of
    2^lookup_bits rows: the same for the same arguments."""
    spec = evm_accumulator_spec(k, lookup_bits)
    n, u = 1 << k, spec.usable_rows
    rng = random.Random(f"evm_accumulator:layout:{k}:{lookup_bits}")
    gates = (u - 1) // 3  # gate g reads rows 3g .. 3g + 3, all usable
    # 1, and the powers 2^(lookup_bits·m) below 2^254 a range gate may scale its value by
    constants = [1] + [pow(2, lookup_bits * m, R)
                       for m in range(1, min(-(-254 // lookup_bits), u - 1))]
    fixed = [[0] * n for _ in range(2 + NUM_ADVICE)]
    fixed[CONSTANTS][:len(constants)] = constants
    fixed[TABLE][:1 << lookup_bits] = list(range(1 << lookup_bits))
    adv = [Col("advice", j) for j in range(NUM_ADVICE + 1)]
    const, inst = Col("fixed", CONSTANTS), Col("instance", 0)
    copies = []
    layout = [[] for _ in range(NUM_ADVICE)]
    next_lookup = 0
    for g in range(gates):
        for j in range(NUM_ADVICE):
            r = 3 * g
            fixed[2 + j][r] = 1
            limb = NUM_ADVICE * g + j
            if limb < NUM_ACC_LIMBS:
                layout[j].append(("limb", -1, 0))
                copies += [((adv[j], r + 1), (inst, limb)), ((adv[j], r + 2), (const, 0))]
            elif next_lookup < u and rng.random() < 0.5:
                layout[j].append(("range", next_lookup, rng.randrange(len(constants))))
                copies += [((adv[j], r + 1), (adv[LOOKUP_ADVICE], next_lookup)),
                           ((adv[j], r + 2), (const, layout[j][-1][2]))]
                next_lookup += 1
            else:
                layout[j].append(("free", -1, -1))
    for j in range(1, NUM_ADVICE):
        copies.append(((adv[j], 0), (adv[j - 1], 3 * gates)))
    return EvmAccumulatorCircuit(k, lookup_bits, spec, fixed, copies, layout)


def valid_accumulator(tau: int, s: int) -> Tuple[tuple, tuple]:
    """(τ·s·G, s·G) affine ints: an accumulator that a KZG decider with
    the trapdoor τ accepts."""
    rhs = py_ec.scalar_mul(py_ec.G1_GEN, s % R)
    return py_ec.scalar_mul(rhs, tau % R), rhs
