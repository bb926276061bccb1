"""A self-contained "standard PLONK" circuit system, protocol builder and
host prover: the counterpart of the JAX package's `system/standard_plonk.py`.

Plays the role the halo2 frontend + `system::halo2::compile` play for the
reference (its system/halo2.rs:82-156 compiles a VerifyingKey into a
PlonkProtocol; the StandardPlonk circuit of its benches lives in
snark-verifier-sdk/benches/standard_plonk.rs).  The same shape of circuit,
natively:

  gate: q_a·a + q_b·b + q_ab·a·b + q_c·c + q_const + instance + q_rot·a(ωX) = 0

with one instance column (evaluated by the verifier via Lagrange sums), three
advice columns in one phase, six fixed columns, and the halo2 vanishing
argument (quotient chunks combined with powers of z^n, chunk_degree 1).

The prover follows the exact transcript discipline PlonkProof.read expects,
so proofs round-trip through the batch verifier bit-exactly.  The
polynomials are python ints (`utils/py_poly.py`); every commitment is
`srs.commit(..., device)`: one MSM on the card (device None), or
`py_ec.msm` (device "cpu").
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Dict, List

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

# poly index layout
N_FIXED = 6  # q_a q_b q_ab q_c q_const q_rot
IDX_INSTANCE = N_FIXED
IDX_A, IDX_B, IDX_C = N_FIXED + 1, N_FIXED + 2, N_FIXED + 3
IDX_QUOTIENT = N_FIXED + 4


def gate_expression() -> Expression:
    P = lambda i, rot=0: Expression.poly(Query(i, rot))
    return (
        P(0) * P(IDX_A)
        + P(1) * P(IDX_B)
        + P(2) * (P(IDX_A) * P(IDX_B))
        + P(3) * P(IDX_C)
        + P(4)
        + P(IDX_INSTANCE)
        + P(5) * P(IDX_A, 1)
    )


@dataclass
class StandardPlonk:
    """Circuit assignment over domain size n = 2^k."""

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
    instance: List[int]  # padded to n with zeros internally

    @staticmethod
    def rand(k: int, seed: int = 0, num_instance: int = 1) -> "StandardPlonk":
        """Random satisfied assignment: row i uses random a,b and selectors,
        solving c so the gate holds; instance value folded into row 0..m-1."""
        n = 1 << k
        rng = random.Random(seed)
        cols = {name: [0] * n for name in
                ["a", "b", "c", "q_a", "q_b", "q_ab", "q_c", "q_const", "q_rot"]}
        instance = [rng.randrange(R) for _ in range(num_instance)]
        inst_padded = instance + [0] * (n - num_instance)
        for i in range(n):
            cols["a"][i] = rng.randrange(R)
            cols["b"][i] = rng.randrange(R)
            cols["q_a"][i] = rng.randrange(R)
            cols["q_b"][i] = rng.randrange(R)
            cols["q_ab"][i] = rng.randrange(R)
            cols["q_const"][i] = rng.randrange(R)
            cols["q_rot"][i] = rng.randrange(R)
            cols["q_c"][i] = 1  # keep solvable for c
        for i in range(n):
            acc = (
                cols["q_a"][i] * cols["a"][i]
                + cols["q_b"][i] * cols["b"][i]
                + cols["q_ab"][i] * cols["a"][i] * cols["b"][i]
                + cols["q_const"][i]
                + inst_padded[i]
                + cols["q_rot"][i] * cols["a"][(i + 1) % n]
            ) % R
            cols["c"][i] = (-acc) * pow(cols["q_c"][i], -1, R) % R
        return StandardPlonk(k=k, instance=instance, **cols)

    def set_instance(self, values: List[int]) -> "StandardPlonk":
        """Replace the instance and re-solve column c so the gate still holds.
        Fixed columns are untouched, so the protocol (and its compiled
        verifier program) is shared across variants — the pattern the
        reference's benches use (one circuit, many instances)."""
        n = 1 << self.k
        if len(values) != len(self.instance):
            raise ValueError(f"{len(values)} instance values for {len(self.instance)}")
        self.instance = [v % R for v in values]
        inst_padded = self.instance + [0] * (n - len(self.instance))
        for i in range(n):
            acc = (
                self.q_a[i] * self.a[i]
                + self.q_b[i] * self.b[i]
                + self.q_ab[i] * self.a[i] * self.b[i]
                + self.q_const[i]
                + inst_padded[i]
                + self.q_rot[i] * self.a[(i + 1) % n]
            ) % R
            self.c[i] = (-acc) * pow(self.q_c[i], -1, R) % R
        return self


def build_protocol(circuit: StandardPlonk, srs, device=None) -> PlonkProtocol:
    """Commit the fixed columns (on `device`, None the card) and assemble the
    PlonkProtocol."""
    domain = Domain.bn254(circuit.k)
    fixed_cols = [circuit.q_a, circuit.q_b, circuit.q_ab, circuit.q_c,
                  circuit.q_const, circuit.q_rot]
    fixed_polys = [_poly_from_evals(col, domain) for col in fixed_cols]
    preprocessed = [srs.commit(f, device) for f in fixed_polys]

    queries = (
        [Query(i, 0) for i in range(N_FIXED)]
        + [Query(IDX_A, 0), Query(IDX_A, 1), Query(IDX_B, 0), Query(IDX_C, 0)]
        + [Query(IDX_QUOTIENT, 0)]
    )
    evaluations = [q for q in queries if q.poly != IDX_QUOTIENT]

    digest = int.from_bytes(
        hashlib.sha256(repr([domain.k, preprocessed]).encode()).digest(), "little"
    ) % R

    return PlonkProtocol(
        domain=domain,
        preprocessed=preprocessed,
        num_instance=[len(circuit.instance)],
        num_witness=[3],
        num_challenge=[0],
        evaluations=evaluations,
        queries=queries,
        quotient=QuotientPolynomial(1, gate_expression()),
        transcript_initial_state=digest,
    )


def _poly_from_evals(evals: List[int], domain: Domain) -> List[int]:
    """Inverse NTT over the domain (O(n log n); k=10-20 circuits are fine)."""
    if len(evals) != domain.n:
        raise ValueError(f"{len(evals)} evaluations for a domain of {domain.n}")
    return pp.intt(evals, domain.gen)


def prove(circuit: StandardPlonk, protocol: PlonkProtocol, srs,
          scheme: str = "shplonk", transcript=None, device=None):
    """Host prover.  Returns (scalars, points) transcript streams.  Pass an
    EvmTranscriptPy to produce keccak-transcript proofs.  Every commitment
    runs on `device` (None: the card)."""
    from ..pcs.kzg.multiopen import Query as PcsQuery
    from ..pcs.kzg.prover_py import gwc_open, shplonk_open

    domain = protocol.domain
    n = domain.n
    fixed_cols = [circuit.q_a, circuit.q_b, circuit.q_ab, circuit.q_c,
                  circuit.q_const, circuit.q_rot]
    fixed_polys = [_poly_from_evals(c, domain) for c in fixed_cols]
    inst_padded = circuit.instance + [0] * (n - len(circuit.instance))
    inst_poly = _poly_from_evals(inst_padded, domain)
    wit_polys = [_poly_from_evals(c, domain) for c in [circuit.a, circuit.b, circuit.c]]

    t = transcript if transcript is not None else PoseidonTranscriptPy()
    if protocol.transcript_initial_state is not None:
        t.common_scalar(protocol.transcript_initial_state)
    for v in circuit.instance:
        t.common_scalar(v)
    for w in wit_polys:
        t.write_ec_point(srs.commit(w, device))

    # quotient: numerator must vanish on H
    polys_by_idx: Dict[int, List[int]] = {i: fixed_polys[i] for i in range(N_FIXED)}
    polys_by_idx[IDX_INSTANCE] = inst_poly
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

    # combined quotient polynomial for the PCS
    zn = pow(z, n, R)
    t_comb: List[int] = []
    for i, ch in enumerate(chunks):
        t_comb = pp.padd(t_comb, pp.pscale(ch, pow(zn, i, R)))
    polys_by_idx[IDX_QUOTIENT] = t_comb

    # write evaluations in protocol order
    for q in protocol.evaluations:
        ev = pp.peval(polys_by_idx[q.poly], z * domain.rotate(q.rotation) % R)
        t.write_scalar(ev)

    # PCS open over protocol.queries
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


def gen_snark(circuit: StandardPlonk, protocol: PlonkProtocol, srs,
              scheme: str = "shplonk", check: bool = True, device=None):
    """Prove and package as an sdk.Snark (reference gen_snark_{gwc,shplonk},
    snark-verifier-sdk/src/halo2.rs:178-260).  check=True re-verifies the
    generated proof through the native-loader verifier before returning, as
    the reference does after every gen_proof (halo2.rs:124-138)."""
    from ..sdk.snark import Snark

    scalars, points = prove(circuit, protocol, srs, scheme=scheme, device=device)
    snark = Snark(
        protocol=protocol,
        instances=[list(circuit.instance)],
        scalars=scalars,
        points=points,
    )
    if check:
        from ..verifier.plonk.verifier import verify_snark_native

        if not verify_snark_native(snark, srs, scheme):
            raise ValueError("self-check verify failed")
    return snark


def _rotate_poly(poly: List[int], rotation: int, domain: Domain) -> List[int]:
    """f(ω^rot · X) in coefficient form."""
    if rotation == 0:
        return poly
    w = domain.rotate(rotation)
    out, x = [], 1
    for c in poly:
        out.append(c * x % R)
        x = x * w % R
    return out
