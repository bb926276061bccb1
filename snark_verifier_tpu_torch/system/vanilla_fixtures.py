"""Parameterized demo circuit for the full halo2-style verification
equation: the counterpart of the JAX package's `system/vanilla_fixtures.py`,
the circuit of the committed vanilla_k10 fixtures (a protocol with
permutation, lookups and user challenges at k = 10).

Domain size and assignment seed are parameters: copy constraints
(chunked permutation grand products, 2 z-polys), a lookup argument,
multi-phase witnesses with a user challenge, rotations, and zk blinding
rows — the protocol shape the reference's `system::halo2::compile` emits
(halo2.rs:82-156,451-655).
"""

from __future__ import annotations

from ..ff.spec import FR
from .vanilla_plonk import Assignment, CircuitSpec, Col, Lookup

R = FR.p


def demo_spec(k: int) -> CircuitSpec:
    spec = CircuitSpec(
        k=k,
        num_fixed=5,  # q, q0 (public), q_l (lookup sel), q_r (rotation), T
        num_advice=[3, 1],  # phase0: a, b, c; phase1: acc
        num_instance=[1],
        num_challenge_user=[1, 0],
        permutation_columns=[
            Col("advice", 0),
            Col("advice", 1),
            Col("advice", 2),
            Col("advice", 0, phase=1),
        ],
    )
    a, b, c = spec.advice(0), spec.advice(1), spec.advice(2)
    acc = spec.advice(0, phase=1)
    q, q0, q_l, q_r, T = (spec.fixed(i) for i in range(5))
    chi = spec.user_challenge(0)
    spec.gates = [
        q * (a + b - c),
        q * (acc - (a + chi * b)),  # phase-1 witness uses the phase-0 challenge
        q0 * (a - spec.instance(0)),  # public input binding
        q_r * (spec.advice(0, rot=1) - b),  # rotation gate: a(wX) = b
    ]
    spec.lookups = [Lookup(input_exprs=[q_l * a], table_exprs=[T])]
    return spec


def demo_assignment(spec: CircuitSpec, seed: int = 0) -> Assignment:
    n = 1 << spec.k
    u = spec.usable_rows
    s = seed % R
    a = [(r * 3 + 1 + s) % R for r in range(n)]
    b = [(r * 7 + 2 + s) % R for r in range(n)]
    a[1] = (a[0] + b[0]) % R  # copy target: a[1] = c[0]
    for r in range(30, 41):
        a[r + 1] = b[r]  # rotation gate rows
    a[6], b[6] = a[5], b[5]  # acc[5] == acc[6] for any chi
    c = [(a[r] + b[r]) % R for r in range(n)]
    b[2] = c[1]  # copy target: b[2] = c[1]
    c[2] = (a[2] + b[2]) % R
    for col in (a, b, c):
        for r in range(u, n):
            col[r] = 0

    q = [1 if r < u else 0 for r in range(n)]
    q0 = [1 if r == 0 else 0 for r in range(n)]
    # lookup rows: inputs q_l·a must land in the table T = [0..u)
    q_l = [1 if (10 <= r < 20 and a[r] < u) else 0 for r in range(n)]
    q_r = [1 if 30 <= r <= 40 else 0 for r in range(n)]
    T = [r if r < u else 0 for r in range(n)]

    def phase1(challenges):
        chi = challenges[0]
        return [[(a[r] + chi * b[r]) % R if r < u else 0 for r in range(n)]]

    A, B, C, ACC = (
        Col("advice", 0),
        Col("advice", 1),
        Col("advice", 2),
        Col("advice", 0, phase=1),
    )
    return Assignment(
        spec=spec,
        fixed=[q, q0, q_l, q_r, T],
        advice_phases=[[a, b, c], phase1],
        instance=[[a[0]]],
        copies=[
            ((C, 0), (A, 1)),
            ((B, 2), (C, 1)),
            ((A, 5), (A, 6)),
            ((B, 5), (B, 6)),
            ((ACC, 5), (ACC, 6)),
        ],
    )
