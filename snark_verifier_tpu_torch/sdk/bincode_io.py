"""Bincode-compatible (de)serialization of `PlonkProtocol`, instances and
whole `Snark`s, the byte format the reference SDK caches to disk: the port's
copy of the JAX package's `sdk/bincode_io.py`, on the port's
`verifier/plonk/protocol.py` and `sdk/proof_io.py`.

The reference persists snarks with `bincode::serialize_into`
(snark-verifier-sdk src/halo2.rs:177,228) and instance files as
`Vec<Vec<[u8; 32]>>` (snark-verifier-sdk src/lib.rs:133-159);
`PlonkProtocol` carries serde derives for exactly this purpose
(snark-verifier src/verifier/plonk/protocol.rs:21-63).  This module
implements bincode v1's default configuration:

  * integers fix-width little-endian; `usize` as u64
  * `Vec<T>`/`String`: u64 length prefix + elements
  * `Option<T>`: u8 tag 0/1 + payload
  * enum: u32 little-endian variant index + payload
  * fixed arrays `[u8; N]`: N raw bytes, no prefix
  * structs/tuples: fields in declaration order, no framing

Schema transcribed from the reference (field order is normative):

  Snark          { protocol, instances: Vec<Vec<Fr>>, proof: Vec<u8> }
                 (snark-verifier-sdk/src/lib.rs:46-60)
  PlonkProtocol  { domain, preprocessed: Vec<C>, num_instance: Vec<usize>,
                   num_witness, num_challenge, evaluations: Vec<Query>,
                   queries: Vec<Query>, quotient, transcript_initial_state:
                   Option<Fr>, instance_committing_key: Option<ICK>,
                   linearization: Option<LinearizationStrategy>,
                   accumulator_indices: Vec<Vec<(usize, usize)>> }
  Domain         { k: usize, n: usize, n_inv: Fr, gen: Fr, gen_inv: Fr }
                 (snark-verifier/src/util/arithmetic.rs:131-142)
  Query          { poly: usize, rotation: Rotation(i32) } (newtype: bare i32)
  Expression     enum tags 0..8: Constant(F), CommonPolynomial(CP),
                 Polynomial(Query), Challenge(usize), Negated(Box),
                 Sum(a, b), Product(a, b), Scaled(a, F),
                 DistributePowers(Vec, Box)  (protocol.rs:309-318)
  CommonPolynomial enum: 0 Identity, 1 Lagrange(i32) (protocol.rs:181-184)
  QuotientPolynomial { chunk_degree: usize, numerator } (protocol.rs:282-285)
  LinearizationStrategy enum: 0 WithoutConstant,
                 1 MinusVanishingTimesQuotient (protocol.rs:504-513)
  InstanceCommittingKey { bases: Vec<C>, constant: Option<C> }

Field-element / point encodings (`fe_codec`): halo2curves' derived binary
serde writes the RAW inner `[u64; 4]` — i.e. 32 LE bytes of the MONTGOMERY
form — and points as the (x, y) field pair ("mont", the default).  Files
produced via `to_bytes`/`to_repr` (e.g. the instance files, lib.rs:155) hold
CANONICAL LE bytes ("canonical").  Both codecs are implemented (INTEROP.md
has the contract).  Non-canonical canonical-codec scalars and off-curve
points raise ValueError.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Tuple

from ..ff.spec import FQ, FR
from ..verifier.plonk.protocol import (
    Domain,
    Expression,
    PlonkProtocol,
    Query,
    QuotientPolynomial,
)

R_FR = 1 << 256  # Montgomery radix for 4x64-bit limbs

_LIN_VARIANTS = ["WithoutConstant", "MinusVanishingTimesQuotient"]


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(
                f"bincode: truncated input at {self.pos}+{n}/{len(self.data)}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def usize(self) -> int:
        return self.u64()

    def vec(self, elem: Callable) -> List:
        n = self.u64()
        if n > len(self.data):  # cheap sanity bound against garbage lengths
            raise ValueError(f"bincode: implausible length {n}")
        return [elem() for _ in range(n)]

    def option(self, elem: Callable):
        tag = self.u8()
        if tag == 0:
            return None
        if tag == 1:
            return elem()
        raise ValueError(f"bincode: bad Option tag {tag}")

    def done(self):
        if self.pos != len(self.data):
            raise ValueError(
                f"bincode: {len(self.data) - self.pos} trailing bytes"
            )


class Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def u8(self, v: int):
        self.raw(bytes([v]))

    def u32(self, v: int):
        self.raw(struct.pack("<I", v))

    def i32(self, v: int):
        self.raw(struct.pack("<i", v))

    def u64(self, v: int):
        self.raw(struct.pack("<Q", v))

    usize = u64

    def vec(self, items, elem: Callable):
        self.u64(len(items))
        for it in items:
            elem(it)

    def option(self, v, elem: Callable):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            elem(v)

    def bytes_out(self) -> bytes:
        return b"".join(self.parts)


# ----------------------------------------------------- field / point codecs


def _fr_read(r: Reader, codec: str) -> int:
    v = int.from_bytes(r.take(32), "little")
    if codec == "mont":
        v = v * pow(R_FR, -1, FR.p) % FR.p
    elif v >= FR.p:
        raise ValueError("non-canonical Fr bytes")
    return v


def _fr_write(w: Writer, v: int, codec: str):
    v %= FR.p
    if codec == "mont":
        v = v * R_FR % FR.p
    w.raw(v.to_bytes(32, "little"))


def _fq_read(r: Reader, codec: str) -> int:
    v = int.from_bytes(r.take(32), "little")
    if codec == "mont":
        v = v * pow(R_FR, -1, FQ.p) % FQ.p
    elif v >= FQ.p:
        raise ValueError("non-canonical Fq bytes")
    return v


def _fq_write(w: Writer, v: int, codec: str):
    v %= FQ.p
    if codec == "mont":
        v = v * R_FR % FQ.p
    w.raw(v.to_bytes(32, "little"))


def _point_read(r: Reader, codec: str) -> Tuple[int, int]:
    x = _fq_read(r, codec)
    y = _fq_read(r, codec)
    if not (x == 0 and y == 0):  # (0,0) encodes identity in halo2curves
        if (y * y - (x * x * x + 3)) % FQ.p != 0:
            raise ValueError(f"bincode point off-curve: ({hex(x)}, {hex(y)})")
    return (x, y)


def _point_write(w: Writer, pt: Tuple[int, int], codec: str):
    _fq_write(w, pt[0], codec)
    _fq_write(w, pt[1], codec)


# ------------------------------------------------------------- protocol IR


def _query_read(r: Reader) -> Query:
    poly = r.usize()
    rot = r.i32()  # Rotation is a serde newtype -> bare i32
    return Query(poly, rot)


def _query_write(w: Writer, q: Query):
    w.usize(q.poly)
    w.i32(q.rotation)


def _expr_read(r: Reader, codec: str) -> Expression:
    tag = r.u32()
    if tag == 0:
        return Expression.constant(_fr_read(r, codec))
    if tag == 1:
        cp = r.u32()
        if cp == 0:
            return Expression.common(("identity",))
        if cp == 1:
            return Expression.common(("lagrange", r.i32()))
        raise ValueError(f"bad CommonPolynomial tag {cp}")
    if tag == 2:
        return Expression.poly(_query_read(r))
    if tag == 3:
        return Expression.challenge(r.usize())
    if tag == 4:
        return -_expr_read(r, codec)
    if tag == 5:
        a = _expr_read(r, codec)
        return a + _expr_read(r, codec)
    if tag == 6:
        a = _expr_read(r, codec)
        return a * _expr_read(r, codec)
    if tag == 7:
        a = _expr_read(r, codec)
        return a * _fr_read(r, codec)
    if tag == 8:
        exprs = r.vec(lambda: _expr_read(r, codec))
        return Expression.distribute_powers(exprs, _expr_read(r, codec))
    raise ValueError(f"bad Expression tag {tag}")


def _expr_write(w: Writer, e: Expression, codec: str):
    k = e.kind
    if k == "const":
        w.u32(0)
        _fr_write(w, e.a, codec)
    elif k == "common":
        w.u32(1)
        if e.a[0] == "identity":
            w.u32(0)
        else:
            w.u32(1)
            w.i32(e.a[1])
    elif k == "poly":
        w.u32(2)
        _query_write(w, e.a)
    elif k == "challenge":
        w.u32(3)
        w.usize(e.a)
    elif k == "neg":
        w.u32(4)
        _expr_write(w, e.a, codec)
    elif k == "sum":
        w.u32(5)
        _expr_write(w, e.a, codec)
        _expr_write(w, e.b, codec)
    elif k == "prod":
        w.u32(6)
        _expr_write(w, e.a, codec)
        _expr_write(w, e.b, codec)
    elif k == "scaled":
        w.u32(7)
        _expr_write(w, e.a, codec)
        _fr_write(w, e.b, codec)
    elif k == "distribute_powers":
        w.u32(8)
        w.vec(e.a, lambda x: _expr_write(w, x, codec))
        _expr_write(w, e.b, codec)
    else:
        raise ValueError(k)


def _domain_read(r: Reader, codec: str) -> Domain:
    k = r.usize()
    n = r.usize()
    n_inv = _fr_read(r, codec)
    gen = _fr_read(r, codec)
    gen_inv = _fr_read(r, codec)
    d = Domain(k, gen)
    if d.n != n or d.n_inv != n_inv or d.gen_inv != gen_inv:
        raise ValueError("bincode Domain: inconsistent derived fields")
    return d


def _domain_write(w: Writer, d: Domain, codec: str):
    w.usize(d.k)
    w.usize(d.n)
    _fr_write(w, d.n_inv, codec)
    _fr_write(w, d.gen, codec)
    _fr_write(w, d.gen_inv, codec)


def read_protocol_reader(r: Reader, fe_codec: str = "mont") -> PlonkProtocol:
    domain = _domain_read(r, fe_codec)
    preprocessed = r.vec(lambda: _point_read(r, fe_codec))
    num_instance = r.vec(r.usize)
    num_witness = r.vec(r.usize)
    num_challenge = r.vec(r.usize)
    evaluations = r.vec(lambda: _query_read(r))
    queries = r.vec(lambda: _query_read(r))
    chunk_degree = r.usize()
    numerator = _expr_read(r, fe_codec)
    transcript_initial_state = r.option(lambda: _fr_read(r, fe_codec))
    ick = r.option(lambda: {
        "bases": r.vec(lambda: _point_read(r, fe_codec)),
        "constant": r.option(lambda: _point_read(r, fe_codec)),
    })
    lin_tag = r.option(r.u32)
    linearization = None if lin_tag is None else _LIN_VARIANTS[lin_tag]
    accumulator_indices = r.vec(
        lambda: r.vec(lambda: (r.usize(), r.usize()))
    )
    return PlonkProtocol(
        domain=domain,
        preprocessed=preprocessed,
        num_instance=num_instance,
        num_witness=num_witness,
        num_challenge=num_challenge,
        evaluations=evaluations,
        queries=queries,
        quotient=QuotientPolynomial(chunk_degree, numerator),
        transcript_initial_state=transcript_initial_state,
        instance_committing_key=ick,
        linearization=linearization,
        accumulator_indices=accumulator_indices,
    )


def read_protocol(data: bytes, fe_codec: str = "mont") -> PlonkProtocol:
    r = Reader(data)
    p = read_protocol_reader(r, fe_codec)
    r.done()
    return p


def write_protocol(p: PlonkProtocol, fe_codec: str = "mont") -> bytes:
    w = Writer()
    _domain_write(w, p.domain, fe_codec)
    w.vec(p.preprocessed, lambda pt: _point_write(w, pt, fe_codec))
    w.vec(p.num_instance, w.usize)
    w.vec(p.num_witness, w.usize)
    w.vec(p.num_challenge, w.usize)
    w.vec(p.evaluations, lambda q: _query_write(w, q))
    w.vec(p.queries, lambda q: _query_write(w, q))
    w.usize(p.quotient.chunk_degree)
    _expr_write(w, p.quotient.numerator, fe_codec)
    w.option(p.transcript_initial_state, lambda v: _fr_write(w, v, fe_codec))

    def _ick(d):
        w.vec(d["bases"], lambda pt: _point_write(w, pt, fe_codec))
        w.option(d.get("constant"), lambda pt: _point_write(w, pt, fe_codec))
    w.option(p.instance_committing_key, _ick)
    w.option(
        None if p.linearization is None else _LIN_VARIANTS.index(p.linearization),
        w.u32,
    )
    w.vec(p.accumulator_indices,
          lambda acc: w.vec(acc, lambda ij: (w.usize(ij[0]), w.usize(ij[1]))))
    return w.bytes_out()


# --------------------------------------------------------------- instances


def read_instances(data: bytes) -> List[List[int]]:
    """Instance files: bincode Vec<Vec<[u8; 32]>> of CANONICAL LE Fr bytes
    (the reference uses Fr::to_bytes — lib.rs:152-159)."""
    r = Reader(data)
    out = r.vec(lambda: r.vec(lambda: _fr_read(r, "canonical")))
    r.done()
    return out


def write_instances(instances: List[List[int]]) -> bytes:
    w = Writer()
    w.vec(instances,
          lambda col: w.vec(col, lambda v: _fr_write(w, v, "canonical")))
    return w.bytes_out()


# -------------------------------------------------------------------- snark


def read_snark(data: bytes, fe_codec: str = "mont", scheme: str = "shplonk",
               proof_fmt: str = "poseidon"):
    """Whole-Snark bincode file (halo2.rs:228): { protocol, instances, proof
    bytes }.  The proof byte blob is decoded with the repo's byte-stream
    codec (sdk/proof_io.py::proof_from_bytes — halo2curves compressed points
    for the Poseidon family, uncompressed EVM words for keccak) against the
    protocol's shape, and the resulting Snark validated."""
    from .proof_io import proof_from_bytes

    r = Reader(data)
    protocol = read_protocol_reader(r, fe_codec)
    instances = r.vec(lambda: r.vec(lambda: _fr_read(r, "canonical")))
    proof = bytes(bytearray(r.vec(r.u8)))
    r.done()
    return proof_from_bytes(protocol, instances, proof, scheme_name=scheme,
                            fmt=proof_fmt)


def write_snark(snark, fe_codec: str = "mont", scheme: str = "shplonk",
                proof_fmt: str = "poseidon") -> bytes:
    from .proof_io import proof_to_bytes

    w = Writer()
    w.raw(write_protocol(snark.protocol, fe_codec))
    w.vec(snark.instances,
          lambda col: w.vec(col, lambda v: _fr_write(w, v, "canonical")))
    proof = proof_to_bytes(snark, scheme_name=scheme, fmt=proof_fmt)
    w.vec(list(proof), w.u8)
    return w.bytes_out()
