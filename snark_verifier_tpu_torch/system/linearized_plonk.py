"""Linearized-PLONK protocol family, the two GWC19 linearization strategies:
the counterpart of the JAX package's `system/linearized_plonk.py`.

The reference's verifier supports three linearization modes
(verifier/plonk/protocol.rs:503-513, proof.rs:250-278):

  * None — every queried poly carries an evaluation; the verifier computes
    the quotient evaluation N(z)/(z^n-1) and opens the quotient commitment
    against it (what halo2 emits; every other system module here).
  * "MinusVanishingTimesQuotient" — current GWC19 linearization: committed
    gate factors stay UNevaluated; the verifier assembles the linearization
    commitment r = Σ eval-scalars·C_fixed − (z^n−1)·C_quotient and opens it
    against 0 (the linearization polynomial evaluates to zero at z).
  * "WithoutConstant" — older GWC19: the prover additionally sends r(z); the
    verifier opens the assembled r commitment against it and checks
    q(z) = (const + r(z))/(z^n−1).

This module produces protocols + proofs that actually TAKE those two
branches: the StandardPlonk gate with the fixed selectors kept committed
(no selector evaluations in the proof), plus a host prover that commits the
linearization polynomial openings the strategies require.

Soundness note for "MinusVanishingTimesQuotient": the numerator expression
must have NO pure-constant term (each product needs a committed factor) so
the claimed opening 0 equals the true one — `compile_protocol` checks this
via the same symbolic fold the prover uses.  Every commitment is
`srs.commit(..., device)`: one MSM on the card (device None), or
`py_ec.msm` (device "cpu").
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..ff.spec import FR
from ..transcript.poseidon_transcript import PoseidonTranscriptPy
from ..utils import py_poly as pp
from ..verifier.plonk.protocol import (
    Domain,
    Expression,
    PlonkProtocol,
    Query,
    QuotientPolynomial,
)

R = FR.p

# poly index layout: 6 fixed, no instance columns, 3 advice
N_FIXED = 6  # q_a q_b q_ab q_c q_const q_rot
IDX_A, IDX_B, IDX_C = N_FIXED, N_FIXED + 1, N_FIXED + 2
IDX_QUOTIENT = N_FIXED + 3
IDX_LIN = IDX_QUOTIENT + 1  # WithoutConstant only

MINUS_VANISHING = "MinusVanishingTimesQuotient"
WITHOUT_CONSTANT = "WithoutConstant"


def gate_expression() -> Expression:
    P = lambda i, rot=0: Expression.poly(Query(i, rot))
    return (
        P(0) * P(IDX_A)
        + P(1) * P(IDX_B)
        + P(2) * (P(IDX_A) * P(IDX_B))
        + P(3) * P(IDX_C)
        + P(4)
        + P(5) * P(IDX_A, 1)
    )


@dataclass
class LinearizedPlonk:
    """StandardPlonk-shaped assignment without an instance column."""

    k: int
    a: List[int]
    b: List[int]
    c: List[int]
    q_a: List[int]
    q_b: List[int]
    q_ab: List[int]
    q_c: List[int]
    q_const: List[int]
    q_rot: List[int]

    @staticmethod
    def rand(k: int, seed: int = 0) -> "LinearizedPlonk":
        n = 1 << k
        rng = random.Random(seed)
        cols = {name: [0] * n for name in
                ["a", "b", "c", "q_a", "q_b", "q_ab", "q_c", "q_const", "q_rot"]}
        for i in range(n):
            for name in ("a", "b", "q_a", "q_b", "q_ab", "q_const", "q_rot"):
                cols[name][i] = rng.randrange(R)
            cols["q_c"][i] = 1
        for i in range(n):
            acc = (
                cols["q_a"][i] * cols["a"][i]
                + cols["q_b"][i] * cols["b"][i]
                + cols["q_ab"][i] * cols["a"][i] * cols["b"][i]
                + cols["q_const"][i]
                + cols["q_rot"][i] * cols["a"][(i + 1) % n]
            ) % R
            cols["c"][i] = (-acc) * pow(cols["q_c"][i], -1, R) % R
        return LinearizedPlonk(k=k, **cols)

    def fixed_cols(self):
        return [self.q_a, self.q_b, self.q_ab, self.q_c, self.q_const, self.q_rot]


def _symbolic_fold(expr: Expression, evals: Dict[Query, int]):
    """Fold the gate into (const, {poly_idx: coeff}) python ints — the host
    mirror of the verifier's Msm linearization (proof.rs:179-281): queried
    polys WITH an evaluation become scalars, the rest stay committed bases."""

    def scale(a, s):
        return (a[0] * s % R, {k: v * s % R for k, v in a[1].items()})

    def add(a, b):
        m = dict(a[1])
        for k, v in b[1].items():
            m[k] = (m.get(k, 0) + v) % R
        return ((a[0] + b[0]) % R, m)

    def prod(a, b):
        if not a[1]:
            return scale(b, a[0])
        if not b[1]:
            return scale(a, b[0])
        raise ValueError("invalid linearization: committed x committed")

    def poly(q):
        if q in evals:
            return (evals[q] % R, {})
        if q.rotation != 0:
            raise ValueError(f"committed poly needs rotation 0: {q}")
        return (0, {q.poly: 1})

    def _raise(_):
        raise ValueError("unsupported node in linearized gate")

    return expr.evaluate(
        lambda v: (v % R, {}),
        _raise,
        poly,
        _raise,
        lambda a: scale(a, R - 1),
        add,
        prod,
        scale,
    )


def compile_protocol(circuit: LinearizedPlonk, srs,
                     strategy: str = MINUS_VANISHING, device=None) -> PlonkProtocol:
    """Commit the fixed columns (on `device`, None the card) and assemble
    the protocol of `strategy`."""
    if strategy not in (MINUS_VANISHING, WITHOUT_CONSTANT):
        raise ValueError(f"unknown linearization strategy {strategy!r}")
    domain = Domain.bn254(circuit.k)
    fixed_polys = [pp.intt(c, domain.gen) for c in circuit.fixed_cols()]
    preprocessed = [srs.commit(f, device) for f in fixed_polys]

    advice_queries = [Query(IDX_A, 0), Query(IDX_A, 1), Query(IDX_B, 0),
                      Query(IDX_C, 0)]
    evaluations = list(advice_queries)
    queries = list(advice_queries) + [Query(IDX_QUOTIENT, 0)]
    if strategy == WITHOUT_CONSTANT:
        evaluations.append(Query(IDX_LIN, 0))
        queries.append(Query(IDX_LIN, 0))
    else:
        # soundness precondition (see module docstring): no constant term
        dummy = {q: 7 for q in advice_queries}
        const, _ = _symbolic_fold(gate_expression(), dummy)
        if const != 0:
            raise ValueError("MinusVanishing gate must have no constant term")

    digest = int.from_bytes(
        hashlib.sha256(repr([strategy, domain.k, preprocessed]).encode()).digest(),
        "little",
    ) % R

    return PlonkProtocol(
        domain=domain,
        preprocessed=preprocessed,
        num_instance=[],
        num_witness=[3],
        num_challenge=[0],
        evaluations=evaluations,
        queries=queries,
        quotient=QuotientPolynomial(1, gate_expression()),
        transcript_initial_state=digest,
        linearization=strategy,
    )


def prove(circuit: LinearizedPlonk, protocol: PlonkProtocol, srs,
          scheme: str = "shplonk", device=None):
    """Host prover for both linearized strategies: identical to the
    StandardPlonk prover up to the evaluation phase, then commits openings
    for the assembled linearization polynomial instead of (or, for
    WithoutConstant, in addition to) plain selector evaluations.  Every
    commitment runs on `device` (None: the card)."""
    from ..pcs.kzg.multiopen import Query as PcsQuery
    from ..pcs.kzg.prover_py import gwc_open, shplonk_open

    strategy = protocol.linearization
    domain = protocol.domain
    n = domain.n
    fixed_polys = [pp.intt(c, domain.gen) for c in circuit.fixed_cols()]
    wit_polys = [pp.intt(c, domain.gen) for c in [circuit.a, circuit.b, circuit.c]]

    t = PoseidonTranscriptPy()
    if protocol.transcript_initial_state is not None:
        t.common_scalar(protocol.transcript_initial_state)
    for w in wit_polys:
        t.write_ec_point(srs.commit(w, device))

    polys_by_idx: Dict[int, List[int]] = {i: fixed_polys[i] for i in range(N_FIXED)}
    polys_by_idx[IDX_A], polys_by_idx[IDX_B], polys_by_idx[IDX_C] = wit_polys

    def poly_of(expr: Expression) -> List[int]:
        return expr.evaluate(
            lambda v: [v],
            lambda cp: (_ for _ in ()).throw(ValueError("common poly in gate")),
            lambda q: _rotate_poly(polys_by_idx[q.poly], q.rotation, domain),
            lambda i: (_ for _ in ()).throw(ValueError("challenge in gate")),
            lambda a: pp.pscale(a, R - 1),
            pp.padd,
            pp.pmul_ntt,
            lambda a, s: pp.pscale(a, s),
        )

    numerator = poly_of(protocol.quotient.numerator)
    t_poly, rem = pp.pdiv_vanishing(numerator, n)
    if rem:
        raise ValueError("constraints unsatisfied")
    num_chunk = protocol.quotient.num_chunk()
    chunks = [t_poly[i * n : (i + 1) * n] or [0] for i in range(num_chunk)]
    for ch in chunks:
        t.write_ec_point(srs.commit(ch, device))

    z = t.squeeze_challenge()
    zn = pow(z, n, R)
    t_comb: List[int] = []
    for i, ch in enumerate(chunks):
        t_comb = pp.padd(t_comb, pp.pscale(ch, pow(zn, i, R)))

    # assemble the linearization polynomial r(X) the verifier's Msm encodes
    evals = {
        q: pp.peval(polys_by_idx[q.poly], z * domain.rotate(q.rotation) % R)
        for q in protocol.evaluations
        if q.poly != IDX_LIN
    }
    const, coeffs = _symbolic_fold(protocol.quotient.numerator, evals)
    r_comm: List[int] = []
    for idx, s in coeffs.items():
        r_comm = pp.padd(r_comm, pp.pscale(polys_by_idx[idx], s))

    if strategy == MINUS_VANISHING:
        lin_poly = pp.padd(r_comm, pp.pscale(t_comb, (R - (zn - 1)) % R))
        if const != 0 or pp.peval(lin_poly, z) % R != 0:
            raise ValueError("the linearization must vanish at z")
        polys_by_idx[IDX_QUOTIENT] = lin_poly
    else:
        polys_by_idx[IDX_QUOTIENT] = t_comb
        polys_by_idx[IDX_LIN] = r_comm
        # verifier will check q(z) == (const + r(z)) / (z^n - 1)
        r_at_z = pp.peval(r_comm, z)
        if (const + r_at_z) % R != pp.peval(t_comb, z) * (zn - 1) % R:
            raise ValueError("q(z) != (const + r(z)) / (z^n - 1)")

    for q in protocol.evaluations:
        ev = pp.peval(polys_by_idx[q.poly], z * domain.rotate(q.rotation) % R)
        t.write_scalar(ev)

    pcs_queries = []
    for q in protocol.queries:
        shift = domain.rotate(q.rotation)
        ev = pp.peval(polys_by_idx[q.poly], z * shift % R)
        pcs_queries.append(PcsQuery(q.poly, shift, ev))
    max_idx = max(polys_by_idx)
    poly_list = [polys_by_idx.get(i, [0]) for i in range(max_idx + 1)]
    opener = shplonk_open if scheme == "shplonk" else gwc_open
    opener(srs, poly_list, pcs_queries, z, t, device)

    return t.streams()


def gen_snark(circuit: LinearizedPlonk, protocol: PlonkProtocol, srs,
              scheme: str = "shplonk", check: bool = True, device=None):
    """Prove on `device` (None: the card) and package as an sdk.Snark;
    check=True re-verifies it by the python-int verifier first."""
    from ..sdk.snark import Snark

    scalars, points = prove(circuit, protocol, srs, scheme=scheme, device=device)
    snark = Snark(protocol=protocol, instances=[], scalars=scalars, points=points)
    if check:
        from ..verifier.plonk.verifier import verify_snark_native

        if not verify_snark_native(snark, srs, scheme):
            raise ValueError("self-check verify failed")
    return snark


def _rotate_poly(poly: List[int], rotation: int, domain: Domain) -> List[int]:
    if rotation == 0:
        return poly
    w = domain.rotate(rotation)
    out, x = [], 1
    for c in poly:
        out.append(c * x % R)
        x = x * w % R
    return out
