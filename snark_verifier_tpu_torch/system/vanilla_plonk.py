"""Vanilla-PLONK circuit system with the full halo2 verification equation:
permutation argument (chunked grand products over copy-constraint cycles),
lookup arguments (permuted-pair + grand product), multi-phase witnesses with
user challenges, and zk blinding-row structure.  The counterpart of the JAX
package's `system/vanilla_plonk.py`: the polynomials are python ints
(`utils/py_poly.py`), and every commitment is `srs.commit(..., device)`,
one MSM on the card (device None) or `py_ec.msm` (device "cpu").

This is the native counterpart of the reference's halo2 protocol compiler
(its system/halo2.rs: `compile` :82-156, the
query/stream layout :284-417, permutation constraints :553-612, lookup
constraints :614-655): a declarative `CircuitSpec` takes the place of a halo2
`ConstraintSystem`, and `compile_protocol` emits a `PlonkProtocol` with the
same constraint structure, challenge schedule, and query ordering a compiled
halo2 VerifyingKey produces — so the device verifier's challenge /
linearization / rotation paths are exercised exactly as they would be by
real halo2 proofs.

Layout (num_proof = 1, query_instance = False, zk = True):

  polys:   [fixed | sigma (permutation) | instance | advice by phase |
            lookup permuted (A'_i, S'_i) | permutation z | lookup z |
            random]  + virtual combined quotient
  witness groups: [advice phase 0, .., advice phase P-1,
                   lookup permuted, zs + random]
  challenges:     [user phase 0, .., user last + theta, (beta, gamma), alpha]

Blinding: rows >= u are unusable, u = n - blinding_factors - 1;
l_last = L_{-(b+1)}, l_blind = sum L_{-b..-1}, l_active = 1 - l_last - l_blind.
"""

from __future__ import annotations

import hashlib
import random as _random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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

# delta = g^(2^s): generator of the odd-order subgroup complement; used to
# give each permutation column a distinct coset id (halo2curves Fr::DELTA).
DELTA = pow(7, 1 << FR.two_adicity, R)


# ------------------------------------------------------------------ frontend


@dataclass(frozen=True)
class Col:
    """A column reference: kind in {'fixed', 'advice', 'instance'};
    for advice, `phase` selects the witness phase."""

    kind: str
    index: int
    phase: int = 0


@dataclass
class Lookup:
    """input_exprs[i] must appear among table_exprs[i] row-wise (compressed
    with theta across the tuple)."""

    input_exprs: List[Expression]
    table_exprs: List[Expression]


@dataclass
class CircuitSpec:
    """Shape + constraint description (the ConstraintSystem analogue)."""

    k: int
    num_fixed: int
    num_advice: List[int]  # per phase
    num_instance: List[int]  # values per instance column
    num_challenge_user: List[int] = field(default_factory=list)  # per phase
    gates: List[Expression] = field(default_factory=list)
    permutation_columns: List[Col] = field(default_factory=list)
    lookups: List[Lookup] = field(default_factory=list)
    blinding_factors: int = 5

    def __post_init__(self):
        if not self.num_challenge_user:
            self.num_challenge_user = [0] * len(self.num_advice)
        if len(self.num_challenge_user) != len(self.num_advice):
            raise ValueError("num_challenge_user needs one entry an advice phase")
        if len(self.num_advice) > 1 and self.num_challenge_user[-1] != 0:
            raise ValueError("user challenges in the last advice phase would collide with "
                             "theta (same restriction the reference layout implies)")
        for c in self.permutation_columns:
            if c.kind not in ("fixed", "advice", "instance"):
                raise ValueError(f"unknown column kind {c.kind!r} in the permutation")

    # ---- layout (mirrors Polynomials offsets, halo2.rs:284-417)

    @property
    def n(self):
        return 1 << self.k

    @property
    def num_perm(self):
        return len(self.permutation_columns)

    @property
    def num_preprocessed(self):
        return self.num_fixed + self.num_perm

    @property
    def instance_offset(self):
        return self.num_preprocessed

    @property
    def witness_offset(self):
        return self.instance_offset + len(self.num_instance)

    @property
    def cs_witness_offset(self):
        return self.witness_offset + sum(self.num_advice)

    @property
    def perm_z_offset(self):
        return self.cs_witness_offset + 2 * len(self.lookups)

    @property
    def lookup_z_offset(self):
        return self.perm_z_offset + self.num_perm_z

    @property
    def random_poly_index(self):
        return self.lookup_z_offset + len(self.lookups)

    @property
    def quotient_index(self):
        return self.random_poly_index + 1

    def poly_index(self, col: Col) -> int:
        # Expressions bake in absolute poly indices, which depend on the
        # number of permutation columns (sigma polys precede instance/advice).
        # Freeze the layout at first use so a later change of
        # permutation_columns can't silently invalidate built expressions.
        sig = (self.num_fixed, tuple(self.num_advice), len(self.num_instance),
               self.num_perm)
        frozen = self.__dict__.setdefault("_layout_sig", sig)
        if frozen != sig:
            raise ValueError("layout changed after expressions were built — set num_fixed/"
                             "num_advice/num_instance/permutation_columns before calling "
                             "fixed()/advice()/instance()")
        if col.kind == "fixed":
            if col.index >= self.num_fixed:
                raise ValueError(f"fixed column {col.index} of {self.num_fixed}")
            return col.index
        if col.kind == "instance":
            return self.instance_offset + col.index
        if col.kind != "advice":
            raise ValueError(f"unknown column kind {col.kind!r}")
        return self.witness_offset + sum(self.num_advice[: col.phase]) + col.index

    # ---- expression constructors for circuit authors

    def query(self, col: Col, rotation: int = 0) -> Expression:
        return Expression.poly(Query(self.poly_index(col), rotation))

    def fixed(self, i: int, rot: int = 0) -> Expression:
        return self.query(Col("fixed", i), rot)

    def advice(self, i: int, rot: int = 0, phase: int = 0) -> Expression:
        return self.query(Col("advice", i, phase), rot)

    def instance(self, i: int, rot: int = 0) -> Expression:
        return self.query(Col("instance", i), rot)

    def user_challenge(self, phase: int, i: int = 0) -> Expression:
        if i >= self.num_challenge_user[phase]:
            raise ValueError(f"user challenge {i} of phase {phase}")
        return Expression.challenge(sum(self.num_challenge_user[:phase]) + i)

    # ---- challenge schedule

    @property
    def total_user_challenges(self):
        return sum(self.num_challenge_user)

    @property
    def theta_index(self):
        return self.total_user_challenges

    @property
    def beta_index(self):
        return self.theta_index + 1

    @property
    def gamma_index(self):
        return self.theta_index + 2

    @property
    def alpha_index(self):
        return self.theta_index + 3

    def num_challenge(self) -> List[int]:
        out = list(self.num_challenge_user)
        out[-1] += 1  # theta
        return out + [2, 1]  # (beta, gamma), alpha

    def num_witness(self) -> List[int]:
        return list(self.num_advice) + [
            2 * len(self.lookups),
            self.num_perm_z + len(self.lookups) + 1,  # zs + random (zk)
        ]

    # ---- degrees / chunking

    @property
    def gate_degree(self):
        degs = [g.degree() for g in self.gates]
        for lk in self.lookups:
            d_in = max([e.degree() for e in lk.input_exprs], default=0)
            d_tab = max([e.degree() for e in lk.table_exprs], default=0)
            # l_active * (z_w (a'+b)(s'+g) - z (in+b)(tab+g))
            degs.append(2 + max(2, d_in + d_tab))
            degs.append(3)  # l_active (a'-s')(a'-a'w^-1)
        return max([3] + degs)

    @property
    def permutation_chunk(self):
        return max(1, self.gate_degree - 2)

    @property
    def num_perm_z(self):
        if not self.num_perm:
            return 0
        w = self.permutation_chunk
        return -(-self.num_perm // w)

    @property
    def rotation_last(self):
        return -(self.blinding_factors + 1)

    @property
    def usable_rows(self):
        """Rows 0..u-1 are active; row u carries l_last; u+1.. are blinding."""
        return self.n - self.blinding_factors - 1

    # -------------------------------------------------------- constraint IR

    def l_0(self):
        return Expression.common(("lagrange", 0))

    def l_last(self):
        return Expression.common(("lagrange", self.rotation_last))

    def l_active(self):
        e = Expression.constant(1) - self.l_last()
        for j in range(self.rotation_last + 1, 0):
            e = e - Expression.common(("lagrange", j))
        return e

    def identity(self):
        return Expression.common(("identity",))

    def permutation_constraints(self) -> List[Expression]:
        """halo2 permutation argument (reference halo2.rs:500-612)."""
        if not self.num_perm:
            return []
        one = Expression.constant(1)
        l_0, l_last, l_active = self.l_0(), self.l_last(), self.l_active()
        beta = Expression.challenge(self.beta_index)
        gamma = Expression.challenge(self.gamma_index)
        ident = self.identity()
        w = self.permutation_chunk

        cols = [self.query(c) for c in self.permutation_columns]
        sigmas = [
            Expression.poly(Query(self.num_fixed + i, 0)) for i in range(self.num_perm)
        ]
        zq = lambda i, rot: Expression.poly(Query(self.perm_z_offset + i, rot))

        out: List[Expression] = [l_0 * (one - zq(0, 0))]
        zl = zq(self.num_perm_z - 1, 0)
        out.append(l_last * (zl * zl - zl))
        for i in range(1, self.num_perm_z):
            out.append(l_0 * (zq(i, 0) - zq(i - 1, self.rotation_last)))
        for i in range(self.num_perm_z):
            chunk = list(range(i * w, min((i + 1) * w, self.num_perm)))
            left = zq(i, 1)
            for j in chunk:
                left = left * (cols[j] + beta * sigmas[j] + gamma)
            right = zq(i, 0)
            for j in chunk:
                right = right * (
                    cols[j] + beta * pow(DELTA, j, R) * ident + gamma
                )
            out.append(l_active * (left - right))
        return out

    def lookup_constraints(self) -> List[Expression]:
        """halo2 lookup argument (reference halo2.rs:614-655)."""
        one = Expression.constant(1)
        l_0, l_last, l_active = self.l_0(), self.l_last(), self.l_active()
        theta = Expression.challenge(self.theta_index)
        beta = Expression.challenge(self.beta_index)
        gamma = Expression.challenge(self.gamma_index)

        out: List[Expression] = []
        for i, lk in enumerate(self.lookups):
            a_p = self.cs_witness_offset + 2 * i
            s_p = a_p + 1
            z = Expression.poly(Query(self.lookup_z_offset + i, 0))
            z_w = Expression.poly(Query(self.lookup_z_offset + i, 1))
            ap0 = Expression.poly(Query(a_p, 0))
            apm = Expression.poly(Query(a_p, -1))
            sp0 = Expression.poly(Query(s_p, 0))
            inp = Expression.distribute_powers(lk.input_exprs, theta)
            tab = Expression.distribute_powers(lk.table_exprs, theta)
            out.append(l_0 * (one - z))
            out.append(l_last * (z * z - z))
            out.append(
                l_active
                * (z_w * ((ap0 + beta) * (sp0 + gamma)) - z * ((inp + beta) * (tab + gamma)))
            )
            out.append(l_0 * (ap0 - sp0))
            out.append(l_active * ((ap0 - sp0) * (ap0 - apm)))
        return out

    def quotient_numerator(self) -> Expression:
        constraints = (
            list(self.gates)
            + self.permutation_constraints()
            + self.lookup_constraints()
        )
        alpha = Expression.challenge(self.alpha_index)
        return Expression.distribute_powers(constraints, alpha)

    # ------------------------------------------------------- query ordering

    def _used_cs_queries(self, kind: str) -> List[Query]:
        """(col, rot) queries of `kind` used by gates/lookups, first-use order
        (the ConstraintSystem query-registry analogue)."""
        lo = self.instance_offset if kind == "instance" else (
            self.witness_offset if kind == "advice" else 0
        )
        hi = (
            self.num_fixed
            if kind == "fixed"
            else (self.witness_offset if kind == "instance" else self.cs_witness_offset)
        )
        seen: Dict[Query, None] = {}
        exprs = list(self.gates)
        for lk in self.lookups:
            exprs.extend(lk.input_exprs)
            exprs.extend(lk.table_exprs)
        for e in exprs:
            for q in sorted(e.used_query(), key=lambda q: (q.poly, q.rotation)):
                if lo <= q.poly < hi:
                    seen.setdefault(q)
        # permutation columns always queried at rot 0
        if kind in ("fixed", "advice"):
            for c in self.permutation_columns:
                if c.kind == kind:
                    seen.setdefault(Query(self.poly_index(c), 0))
        return list(seen)

    def advice_queries(self) -> List[Query]:
        return self._used_cs_queries("advice")

    def fixed_queries(self) -> List[Query]:
        return self._used_cs_queries("fixed")

    def permutation_fixed_queries(self) -> List[Query]:
        return [Query(self.num_fixed + i, 0) for i in range(self.num_perm)]

    def permutation_z_queries(self, for_eval: bool) -> List[Query]:
        """EVAL ordering interleaves the rot_last query per z; the PCS
        ordering appends them reversed (reference halo2.rs:338-369)."""
        zs = [self.perm_z_offset + i for i in range(self.num_perm_z)]
        out: List[Query] = []
        if for_eval:
            for i, z in enumerate(zs):
                out += [Query(z, 0), Query(z, 1)]
                if i != self.num_perm_z - 1:
                    out.append(Query(z, self.rotation_last))
        else:
            for z in zs:
                out += [Query(z, 0), Query(z, 1)]
            for z in reversed(zs[:-1]):
                out.append(Query(z, self.rotation_last))
        return out

    def lookup_queries(self, for_eval: bool) -> List[Query]:
        out: List[Query] = []
        for i in range(len(self.lookups)):
            z = self.lookup_z_offset + i
            a_p = self.cs_witness_offset + 2 * i
            s_p = a_p + 1
            if for_eval:
                out += [Query(z, 0), Query(z, 1), Query(a_p, 0), Query(a_p, -1), Query(s_p, 0)]
            else:
                out += [Query(z, 0), Query(a_p, 0), Query(s_p, 0), Query(a_p, -1), Query(z, 1)]
        return out

    def evaluations(self) -> List[Query]:
        return (
            self.advice_queries()
            + self.fixed_queries()
            + [Query(self.random_poly_index, 0)]
            + self.permutation_fixed_queries()
            + self.permutation_z_queries(True)
            + self.lookup_queries(True)
        )

    def queries(self) -> List[Query]:
        return (
            self.advice_queries()
            + self.permutation_z_queries(False)
            + self.lookup_queries(False)
            + self.fixed_queries()
            + self.permutation_fixed_queries()
            + [Query(self.quotient_index, 0)]
            + [Query(self.random_poly_index, 0)]
        )


# ------------------------------------------------------------------ protocol


def compile_protocol(spec: CircuitSpec, fixed_cols: List[List[int]],
                     copies: List[Tuple[Tuple[Col, int], Tuple[Col, int]]],
                     srs, device=None,
                     accumulator_indices: Sequence[Sequence[Tuple[int, int]]] = ()
                     ) -> PlonkProtocol:
    """Commit the preprocessed polynomials (fixed + permutation sigmas) on
    `device` (None: the card) and assemble the PlonkProtocol (reference
    compile(), halo2.rs:82-156).

    copies: [((col, row), (col, row))] copy constraints; rows must be active.
    A copy may name an instance column where the spec permutes it (its
    values then enter the grand product as any other column's).
    accumulator_indices: the (column, row) instances of each old
    accumulator the proofs carry as 12 limbs (`pcs/kzg/accumulator.py`).
    """
    domain = Domain.bn254(spec.k)
    if len(fixed_cols) != spec.num_fixed:
        raise ValueError(f"{len(fixed_cols)} fixed columns for {spec.num_fixed}")
    sigma_evals = _sigma_evals(spec, copies, domain)
    pre_polys = [pp.intt(list(c), domain.gen) for c in fixed_cols] + [
        pp.intt(s, domain.gen) for s in sigma_evals
    ]
    preprocessed = [srs.commit(f, device) for f in pre_polys]

    digest = int.from_bytes(
        hashlib.sha256(repr([spec.k, preprocessed]).encode()).digest(), "little"
    ) % R

    return PlonkProtocol(
        domain=domain,
        preprocessed=preprocessed,
        num_instance=list(spec.num_instance),
        num_witness=spec.num_witness(),
        num_challenge=spec.num_challenge(),
        evaluations=spec.evaluations(),
        queries=spec.queries(),
        quotient=QuotientPolynomial(1, spec.quotient_numerator()),
        transcript_initial_state=digest,
        accumulator_indices=[[tuple(ij) for ij in acc] for acc in accumulator_indices],
    )


def _sigma_evals(spec: CircuitSpec, copies, domain: Domain) -> List[List[int]]:
    """Permutation sigma polynomials from copy constraints: group copied
    cells into cycles (union-find), each class becomes one rotation cycle;
    sigma_j(row r) = delta^j' * omega^r' where (j', r') = mapping(j, r).
    (The reference consumes halo2's equivalent from the vk; the cycle
    construction itself lives in halo2_proofs' permutation keygen.)"""
    n, u = domain.n, spec.usable_rows
    col_pos = {
        (c.kind, c.index, c.phase): i for i, c in enumerate(spec.permutation_columns)
    }

    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    members: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    cells = []
    for (ca, ra), (cb, rb) in copies:
        a = (col_pos[(ca.kind, ca.index, ca.phase)], ra)
        b = (col_pos[(cb.kind, cb.index, cb.phase)], rb)
        if ra >= u or rb >= u:
            raise ValueError("copy constraints must stay in active rows")
        cells += [a, b]
        ra_, rb_ = find(a), find(b)
        if ra_ != rb_:
            parent[ra_] = rb_
    for cell in cells:
        members.setdefault(find(cell), []).append(cell)

    mapping = {}
    for group in members.values():
        group = sorted(set(group))
        for i, cell in enumerate(group):
            mapping[cell] = group[(i + 1) % len(group)]

    out = []
    for j in range(spec.num_perm):
        col = []
        for r in range(n):
            jp, rp = mapping.get((j, r), (j, r))
            col.append(pow(DELTA, jp, R) * domain.rotate(rp) % R)
        out.append(col)
    return out


# -------------------------------------------------------------------- prover


@dataclass
class Assignment:
    """A satisfied circuit instance.  Advice phases beyond the first may be
    callables (challenges_so_far: Dict[int, int]) -> List[List[int]] so
    later-phase witnesses can depend on earlier challenges."""

    spec: CircuitSpec
    fixed: List[List[int]]
    advice_phases: List  # per phase: List[List[int]] | callable
    instance: List[List[int]]
    copies: List[Tuple[Tuple[Col, int], Tuple[Col, int]]] = field(default_factory=list)


def prove(asg: Assignment, protocol: PlonkProtocol, srs,
          scheme: str = "shplonk", transcript=None, seed: int = 0, device=None):
    """Host prover with the exact transcript discipline PlonkProof.read
    expects (reference proof stream layout: verifier/plonk/proof.rs:52-153).
    Returns (scalars, points) streams.  Every commitment runs on `device`
    (None: the card)."""
    from ..pcs.kzg.multiopen import Query as PcsQuery
    from ..pcs.kzg.prover_py import gwc_open, shplonk_open

    spec, domain = asg.spec, protocol.domain
    n, u = domain.n, spec.usable_rows
    rng = _random.Random(seed ^ 0x5EED)
    rand_fr = lambda: rng.randrange(R)

    t = transcript if transcript is not None else PoseidonTranscriptPy()
    if protocol.transcript_initial_state is not None:
        t.common_scalar(protocol.transcript_initial_state)
    for col in asg.instance:
        for v in col:
            t.common_scalar(v)

    evals_by_idx: Dict[int, List[int]] = {}
    coeffs_by_idx: Dict[int, List[int]] = {}

    def put(idx: int, evals: List[int]):
        evals_by_idx[idx] = evals
        coeffs_by_idx[idx] = pp.intt(list(evals), domain.gen)

    for i, col in enumerate(asg.fixed):
        put(i, col)
    for j, sig in enumerate(_sigma_evals(spec, asg.copies, domain)):
        put(spec.num_fixed + j, sig)
    for i, col in enumerate(asg.instance):
        put(spec.instance_offset + i, list(col) + [0] * (n - len(col)))

    challenges: Dict[int, int] = {}

    def squeeze_into(indices):
        for ci in indices:
            challenges[ci] = t.squeeze_challenge()

    # --- witness phases: advice (+ user challenges, theta on the last)
    chal_cursor = 0
    for phase, cols in enumerate(asg.advice_phases):
        if callable(cols):
            cols = cols(dict(challenges))
        if len(cols) != spec.num_advice[phase]:
            raise ValueError(f"phase {phase}: {len(cols)} advice columns for "
                             f"{spec.num_advice[phase]}")
        for j, col in enumerate(cols):
            idx = spec.witness_offset + sum(spec.num_advice[:phase]) + j
            col = list(col)
            # zk: fill the blinding rows (>= u) of every advice column with
            # random field elements before committing, as halo2's prover does
            # — without this the commitments leak the witness tail.  Gate
            # selectors vanish on rows >= u (l_active), so constraints still
            # hold; the quotient-division check below would catch a circuit
            # whose selectors don't.
            col[u:] = [rand_fr() for _ in range(n - u)]
            put(idx, col)
            t.write_ec_point(srs.commit(coeffs_by_idx[idx], device))
        m = spec.num_challenge()[phase]
        squeeze_into(range(chal_cursor, chal_cursor + m))
        chal_cursor += m

    theta = challenges[spec.theta_index]

    # --- lookup permuted pairs (A'_i, S'_i)
    def expr_evals(e: Expression) -> List[int]:
        """Row-wise evaluation of a constraint-system expression."""
        return e.evaluate(
            lambda v: [v] * n,
            lambda cp: (_ for _ in ()).throw(ValueError("common poly in cs expr")),
            lambda q: [evals_by_idx[q.poly][(r + q.rotation) % n] for r in range(n)],
            lambda ci: [challenges[ci]] * n,
            lambda a: [(-x) % R for x in a],
            lambda a, b: [(x + y) % R for x, y in zip(a, b)],
            lambda a, b: [x * y % R for x, y in zip(a, b)],
            lambda a, s: [x * s % R for x in a],
        )

    def compress(exprs: List[Expression]) -> List[int]:
        acc = expr_evals(exprs[0])
        for e in exprs[1:]:
            ev = expr_evals(e)
            acc = [(a * theta + v) % R for a, v in zip(acc, ev)]
        return acc

    lookup_data = []
    for li, lk in enumerate(spec.lookups):
        inp, tab = compress(lk.input_exprs), compress(lk.table_exprs)
        a_sorted = sorted(inp[:u])
        from collections import Counter

        remaining = Counter(tab[:u])
        s_perm: List[Optional[int]] = [None] * u
        for r in range(u):
            if r == 0 or a_sorted[r] != a_sorted[r - 1]:
                if remaining[a_sorted[r]] <= 0:
                    raise ValueError(
                        f"lookup {li}: input value not in table ({a_sorted[r]})"
                    )
                remaining[a_sorted[r]] -= 1
                s_perm[r] = a_sorted[r]
        leftovers = list(remaining.elements())
        it = iter(leftovers)
        for r in range(u):
            if s_perm[r] is None:
                s_perm[r] = next(it)
        blind = lambda: [rand_fr() for _ in range(n - u)]
        a_col = a_sorted + blind()
        s_col = list(s_perm) + blind()
        put(spec.cs_witness_offset + 2 * li, a_col)
        put(spec.cs_witness_offset + 2 * li + 1, s_col)
        t.write_ec_point(srs.commit(coeffs_by_idx[spec.cs_witness_offset + 2 * li], device))
        t.write_ec_point(srs.commit(coeffs_by_idx[spec.cs_witness_offset + 2 * li + 1],
                                    device))
        lookup_data.append((inp, tab, a_col, s_col))

    squeeze_into([spec.beta_index, spec.gamma_index])
    beta, gamma = challenges[spec.beta_index], challenges[spec.gamma_index]

    # --- permutation grand products (chunked, carried across chunks)
    w = spec.permutation_chunk
    perm_cols = [evals_by_idx[spec.poly_index(c)] for c in spec.permutation_columns]
    sigma_cols = [evals_by_idx[spec.num_fixed + j] for j in range(spec.num_perm)]
    carry = 1
    for i in range(spec.num_perm_z):
        chunk = list(range(i * w, min((i + 1) * w, spec.num_perm)))
        z = [0] * n
        z[0] = carry
        for r in range(u):
            num = den = 1
            for j in chunk:
                ident = pow(DELTA, j, R) * domain.rotate(r) % R
                num = num * ((perm_cols[j][r] + beta * ident + gamma) % R) % R
                den = den * ((perm_cols[j][r] + beta * sigma_cols[j][r] + gamma) % R) % R
            z[r + 1] = z[r] * num % R * pow(den, -1, R) % R
        carry = z[u]
        for r in range(u + 1, n):
            z[r] = rand_fr()
        put(spec.perm_z_offset + i, z)
    if spec.num_perm_z and carry != 1:
        raise ValueError("copy constraints unsatisfied")

    # --- lookup grand products
    for li, (inp, tab, a_col, s_col) in enumerate(lookup_data):
        z = [0] * n
        z[0] = 1
        for r in range(u):
            num = (inp[r] + beta) * (tab[r] + gamma) % R
            den = (a_col[r] + beta) * (s_col[r] + gamma) % R
            z[r + 1] = z[r] * num % R * pow(den, -1, R) % R
        if z[u] != 1:
            raise ValueError("lookup product must telescope")
        for r in range(u + 1, n):
            z[r] = rand_fr()
        put(spec.lookup_z_offset + li, z)

    # --- random (zk) poly
    put(spec.random_poly_index, [rand_fr() for _ in range(n)])

    for i in range(spec.num_perm_z):
        t.write_ec_point(srs.commit(coeffs_by_idx[spec.perm_z_offset + i], device))
    for li in range(len(spec.lookups)):
        t.write_ec_point(srs.commit(coeffs_by_idx[spec.lookup_z_offset + li], device))
    t.write_ec_point(srs.commit(coeffs_by_idx[spec.random_poly_index], device))
    squeeze_into([spec.alpha_index])

    # --- quotient
    lagrange_cache: Dict[int, List[int]] = {}

    def lagrange_poly(i: int) -> List[int]:
        r = i % n
        if r not in lagrange_cache:
            onehot = [0] * n
            onehot[r] = 1
            lagrange_cache[r] = pp.intt(onehot, domain.gen)
        return lagrange_cache[r]

    def poly_of(e: Expression) -> List[int]:
        return e.evaluate(
            lambda v: [v],
            lambda cp: [0, 1] if cp[0] == "identity" else lagrange_poly(cp[1]),
            lambda q: _rotate_coeffs(coeffs_by_idx[q.poly], q.rotation, domain),
            lambda ci: [challenges[ci]],
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

    x = t.squeeze_challenge()

    xn = pow(x, n, R)
    t_comb: List[int] = []
    for i, ch in enumerate(chunks):
        t_comb = pp.padd(t_comb, pp.pscale(ch, pow(xn, i, R)))
    coeffs_by_idx[spec.quotient_index] = t_comb

    for q in protocol.evaluations:
        ev = pp.peval(coeffs_by_idx[q.poly], x * domain.rotate(q.rotation) % R)
        t.write_scalar(ev)

    pcs_queries = []
    for q in protocol.queries:
        shift = domain.rotate(q.rotation)
        ev = pp.peval(coeffs_by_idx[q.poly], x * shift % R)
        pcs_queries.append(PcsQuery(q.poly, shift, ev))
    max_idx = max(coeffs_by_idx)
    poly_list = [coeffs_by_idx.get(i, [0]) for i in range(max_idx + 1)]
    opener = shplonk_open if scheme == "shplonk" else gwc_open
    opener(srs, poly_list, pcs_queries, x, t, device)

    return t.streams()


def gen_snark(asg: Assignment, protocol: PlonkProtocol, srs,
              scheme: str = "shplonk", seed: int = 0, check: bool = True,
              transcript: str = "poseidon", device=None):
    """check=True re-verifies the generated proof through the native-loader
    verifier before returning (reference self-check, halo2.rs:124-138).
    transcript: "poseidon" or "evm" (keccak Fiat-Shamir, the on-chain proof
    family — reference gen_evm_proof_*, snark-verifier-sdk/src/evm.rs:37-108).
    Every commitment runs on `device` (None: the card)."""
    from ..sdk.snark import Snark
    from ..transcript.evm_transcript import EvmTranscriptPy

    t = EvmTranscriptPy() if transcript == "evm" else None
    scalars, points = prove(asg, protocol, srs, scheme=scheme, seed=seed,
                            transcript=t, device=device)
    snark = Snark(
        protocol=protocol,
        instances=[list(c) for c in asg.instance],
        scalars=scalars,
        points=points,
    )
    if check:
        from ..verifier.plonk.verifier import verify_snark_native

        if not verify_snark_native(snark, srs, scheme, transcript=transcript):
            raise ValueError("self-check verify failed")
    return snark


def _rotate_coeffs(poly: List[int], rotation: int, domain: Domain) -> List[int]:
    """f(omega^rot * X) in coefficient form."""
    if rotation == 0:
        return poly
    w = domain.rotate(rotation)
    out, x = [], 1
    for c in poly:
        out.append(c * x % R)
        x = x * w % R
    return out
