"""PLONK protocol IR: the serializable description of a halo2/PLONK
circuit's verification equation.  A host-side copy of the JAX package's
`verifier/plonk/protocol.py`, kept here so the port imports nothing of that
package.

Mirrors the reference's verifier/plonk/protocol.rs:
  * `PlonkProtocol` (:21-63) — domain, preprocessed commitments, stream shape
    (num_instance / num_witness / num_challenge), evaluation & PCS queries,
    quotient expression, transcript initial state, accumulator indices
  * symbolic `Expression` AST with fold-style evaluate (:309-418)
  * `QuotientPolynomial::num_chunk` (:287-294), `LinearizationStrategy`
    (:503-513)

Field values are plain python ints, so a protocol is host data that the
verifier walks while it issues the batch's kernels; a serde-style JSON
(de)serializer reads the protocols of the committed fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ...ff.spec import FR

R = FR.p


# --------------------------------------------------------------- expression


@dataclass(frozen=True)
class Query:
    poly: int
    rotation: int

    def to_json(self):
        return {"poly": self.poly, "rotation": self.rotation}

    @staticmethod
    def from_json(d):
        return Query(d["poly"], d["rotation"])


class Expression:
    """Tagged-union AST.  kind in {const, common, poly, challenge, neg, sum,
    prod, scaled, distribute_powers}."""

    __slots__ = ("kind", "a", "b")

    def __init__(self, kind: str, a=None, b=None):
        self.kind = kind
        self.a = a
        self.b = b

    # constructors
    @staticmethod
    def constant(v: int):
        return Expression("const", v % R)

    @staticmethod
    def common(cp):
        """cp: ('identity',) or ('lagrange', i)."""
        return Expression("common", cp)

    @staticmethod
    def poly(q: Query):
        return Expression("poly", q)

    @staticmethod
    def challenge(idx: int):
        return Expression("challenge", idx)

    @staticmethod
    def distribute_powers(exprs: List["Expression"], base: "Expression"):
        return Expression("distribute_powers", list(exprs), base)

    # operators
    def __neg__(self):
        return Expression("neg", self)

    def __add__(self, other):
        return Expression("sum", self, _as_expr(other))

    def __sub__(self, other):
        return Expression("sum", self, -_as_expr(other))

    def __mul__(self, other):
        if isinstance(other, int):
            return Expression("scaled", self, other % R)
        return Expression("prod", self, other)

    __rmul__ = __mul__

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        """Fold (mirrors protocol.rs:322-370)."""
        ev = lambda e: e.evaluate(
            constant, common_poly, poly, challenge, negated, sum_, product, scaled
        )
        k = self.kind
        if k == "const":
            return constant(self.a)
        if k == "common":
            return common_poly(self.a)
        if k == "poly":
            return poly(self.a)
        if k == "challenge":
            return challenge(self.a)
        if k == "neg":
            return negated(ev(self.a))
        if k == "sum":
            return sum_(ev(self.a), ev(self.b))
        if k == "prod":
            return product(ev(self.a), ev(self.b))
        if k == "scaled":
            return scaled(ev(self.a), self.b)
        if k == "distribute_powers":
            exprs = self.a
            assert exprs
            if len(exprs) == 1:
                return ev(exprs[0])
            base = ev(self.b)
            acc = ev(exprs[0])
            for e in exprs[1:]:
                acc = sum_(product(acc, base), ev(e))
            return acc
        raise ValueError(k)

    def degree(self) -> int:
        k = self.kind
        if k in ("const", "challenge"):
            return 0
        if k in ("common", "poly"):
            return 1
        if k in ("neg", "scaled"):
            return self.a.degree()
        if k == "sum":
            return max(self.a.degree(), self.b.degree())
        if k == "prod":
            return self.a.degree() + self.b.degree()
        if k == "distribute_powers":
            return max(max(e.degree() for e in self.a), self.b.degree())
        raise ValueError(k)

    def _collect(self, want: str, out: set):
        k = self.kind
        if k == "common" and want == "lagrange" and self.a[0] == "lagrange":
            out.add(self.a[1])
        elif k == "poly" and want == "query":
            out.add(self.a)
        elif k in ("neg", "scaled"):
            self.a._collect(want, out)
        elif k in ("sum", "prod"):
            self.a._collect(want, out)
            self.b._collect(want, out)
        elif k == "distribute_powers":
            for e in self.a:
                e._collect(want, out)
            self.b._collect(want, out)

    def used_lagrange(self) -> set:
        out: set = set()
        self._collect("lagrange", out)
        return out

    def used_query(self) -> set:
        out: set = set()
        self._collect("query", out)
        return out

    # ---- serde-style JSON
    def to_json(self):
        k = self.kind
        if k == "const":
            return {"Constant": hex(self.a)}
        if k == "common":
            cp = self.a
            return {"CommonPolynomial": "Identity" if cp[0] == "identity" else {"Lagrange": cp[1]}}
        if k == "poly":
            return {"Polynomial": self.a.to_json()}
        if k == "challenge":
            return {"Challenge": self.a}
        if k == "neg":
            return {"Negated": self.a.to_json()}
        if k == "sum":
            return {"Sum": [self.a.to_json(), self.b.to_json()]}
        if k == "prod":
            return {"Product": [self.a.to_json(), self.b.to_json()]}
        if k == "scaled":
            return {"Scaled": [self.a.to_json(), hex(self.b)]}
        if k == "distribute_powers":
            return {"DistributePowers": [[e.to_json() for e in self.a], self.b.to_json()]}
        raise ValueError(k)

    @staticmethod
    def from_json(d):
        (tag, val), = d.items()
        if tag == "Constant":
            return Expression.constant(_int(val))
        if tag == "CommonPolynomial":
            if val == "Identity":
                return Expression.common(("identity",))
            return Expression.common(("lagrange", val["Lagrange"]))
        if tag == "Polynomial":
            return Expression.poly(Query.from_json(val))
        if tag == "Challenge":
            return Expression.challenge(val)
        if tag == "Negated":
            return -Expression.from_json(val)
        if tag == "Sum":
            return Expression.from_json(val[0]) + Expression.from_json(val[1])
        if tag == "Product":
            return Expression.from_json(val[0]) * Expression.from_json(val[1])
        if tag == "Scaled":
            return Expression.from_json(val[0]) * _int(val[1])
        if tag == "DistributePowers":
            return Expression.distribute_powers(
                [Expression.from_json(e) for e in val[0]], Expression.from_json(val[1])
            )
        raise ValueError(tag)


def _as_expr(x):
    if isinstance(x, Expression):
        return x
    return Expression.constant(x)


def _int(v):
    return int(v, 16) if isinstance(v, str) else int(v)


# ------------------------------------------------------------------- domain


@dataclass
class Domain:
    """2-adic multiplicative subgroup (reference util/arithmetic.rs:131-162)."""

    k: int
    gen: int

    def __post_init__(self):
        self.n = 1 << self.k
        self.n_inv = pow(self.n, -1, R)
        self.gen_inv = pow(self.gen, -1, R)

    def rotate(self, rotation: int) -> int:
        """ω^rotation (as a python int)."""
        if rotation >= 0:
            return pow(self.gen, rotation, R)
        return pow(self.gen_inv, -rotation, R)

    @staticmethod
    def bn254(k: int) -> "Domain":
        """The standard BN254 Fr domain of size 2^k: ω the 2^k-th root of
        unity made from Fr*'s generator 7 (halo2curves' ROOT_OF_UNITY)."""
        s = FR.two_adicity
        root = pow(7, (R - 1) >> s, R)  # a primitive 2^s-th root of unity
        return Domain(k, pow(root, 1 << (s - k), R))

    def to_json(self):
        return {"k": self.k, "n": self.n, "n_inv": hex(self.n_inv), "gen": hex(self.gen),
                "gen_inv": hex(self.gen_inv)}

    @staticmethod
    def from_json(d):
        return Domain(d["k"], _int(d["gen"]))


# ----------------------------------------------------------------- protocol


@dataclass
class QuotientPolynomial:
    chunk_degree: int
    numerator: Expression

    def num_chunk(self) -> int:
        d = max(self.numerator.degree() - 1, 0)
        return -(-d // self.chunk_degree)


@dataclass
class PlonkProtocol:
    domain: Domain
    preprocessed: List  # affine int point tuples
    num_instance: List[int]
    num_witness: List[int]
    num_challenge: List[int]
    evaluations: List[Query]
    queries: List[Query]
    quotient: QuotientPolynomial
    transcript_initial_state: Optional[int] = None
    instance_committing_key: Optional[Dict] = None  # {bases: [pt], constant: pt?}
    linearization: Optional[str] = None  # None | "WithoutConstant" | "MinusVanishingTimesQuotient"
    accumulator_indices: List[List[Tuple[int, int]]] = field(default_factory=list)

    def langranges(self):
        """Lagrange indices the verifier needs (protocol.rs:70-98)."""
        out = set(self.quotient.numerator.used_lagrange())
        if self.instance_committing_key is None:
            offset = len(self.preprocessed)
            rng = range(offset, offset + len(self.num_instance))
            rots = [
                q.rotation for q in self.quotient.numerator.used_query() if q.poly in rng
            ]
            min_rot = min([0] + rots)
            max_rot = max([0] + rots)
            max_inst = max(self.num_instance, default=0)
            out.update(range(-max_rot, max_inst + abs(min_rot)))
        return sorted(out)

    def content_hash(self) -> str:
        """Stable digest of the full protocol content: a batch verifies one
        protocol, and this is how the batch checks that it does."""
        import hashlib
        import json

        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    # ---- JSON interchange
    def to_json(self):
        return {
            "domain": self.domain.to_json(),
            "preprocessed": [[hex(x), hex(y)] for x, y in self.preprocessed],
            "num_instance": self.num_instance,
            "num_witness": self.num_witness,
            "num_challenge": self.num_challenge,
            "evaluations": [q.to_json() for q in self.evaluations],
            "queries": [q.to_json() for q in self.queries],
            "quotient": {
                "chunk_degree": self.quotient.chunk_degree,
                "numerator": self.quotient.numerator.to_json(),
            },
            "transcript_initial_state": (
                hex(self.transcript_initial_state)
                if self.transcript_initial_state is not None
                else None
            ),
            "instance_committing_key": self.instance_committing_key,
            "linearization": self.linearization,
            "accumulator_indices": [
                [list(ij) for ij in acc] for acc in self.accumulator_indices
            ],
        }

    @staticmethod
    def from_json(d):
        return PlonkProtocol(
            domain=Domain.from_json(d["domain"]),
            preprocessed=[(_int(x), _int(y)) for x, y in d["preprocessed"]],
            num_instance=d["num_instance"],
            num_witness=d["num_witness"],
            num_challenge=d["num_challenge"],
            evaluations=[Query.from_json(q) for q in d["evaluations"]],
            queries=[Query.from_json(q) for q in d["queries"]],
            quotient=QuotientPolynomial(
                d["quotient"]["chunk_degree"],
                Expression.from_json(d["quotient"]["numerator"]),
            ),
            transcript_initial_state=(
                _int(d["transcript_initial_state"])
                if d.get("transcript_initial_state") is not None
                else None
            ),
            instance_committing_key=d.get("instance_committing_key"),
            linearization=d.get("linearization"),
            accumulator_indices=[
                [tuple(ij) for ij in acc] for acc in d.get("accumulator_indices", [])
            ],
        )
