"""Byte-level proof codecs, the wire formats the reference reads and
writes: a copy of the JAX package's `sdk/proof_io.py` (:38-172).

Two formats, one per native transcript:

* "poseidon" (halo2curves-native): a scalar is 32 little-endian bytes of
  its reduced Fr value; a coordinate 32 little-endian bytes of its reduced
  value; a G1 point 32 bytes of compressed x, the parity of the canonical y
  in bit 7 of byte 31, the identity all zeros (the reference's
  PoseidonTranscript, system/halo2/transcript/halo2.rs:229-262).
* "evm": 32-byte big-endian words; a point is x ‖ y uncompressed, 64 bytes,
  and the identity has no encoding (transcript/evm.rs:205-230).

A proof's bytes interleave its values in transcript-read order, three runs
for every protocol and scheme: [witness and quotient points] [evaluation
scalars] [PCS proof points] (verifier/plonk/proof.rs:52-153; the GWC19 and
SHPLONK PCS proofs are points only).  `proof_to_bytes` and
`proof_from_bytes` carry a Snark through that layout; decoding checks that
every field element is reduced and every point lies on the curve, raising
`errors.TranscriptError` as the reference's `from_repr` / `from_bytes`
checks do.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import errors
from ..ff.spec import FQ, FR
from ..verifier.plonk.protocol import PlonkProtocol

Q = FQ.p
R = FR.p


# --------------------------------------------------------------- field codec


def fr_to_bytes(v: int) -> bytes:
    if not 0 <= v < R:
        raise ValueError("fr_to_bytes: the scalar is not reduced")
    return int(v).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= R:
        raise errors.TranscriptError("Invalid scalar encoding in proof")
    return v


def fq_to_bytes(v: int) -> bytes:
    if not 0 <= v < Q:
        raise ValueError("fq_to_bytes: the coordinate is not reduced")
    return int(v).to_bytes(32, "little")


def fq_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= Q:
        raise errors.TranscriptError("Invalid coordinate encoding in proof")
    return v


# --------------------------------------------------------------- point codec


def g1_to_bytes(pt) -> bytes:
    """Compressed halo2curves encoding: x little-endian with the parity of y
    in bit 7 of byte 31; the identity is 32 zero bytes."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(fq_to_bytes(x))
    b[31] |= (y & 1) << 7
    return bytes(b)


def g1_from_bytes(b: bytes):
    """Decompress, which checks that the point is on the curve."""
    raw = bytearray(b)
    ysign = raw[31] >> 7
    raw[31] &= 0x7F
    x = fq_from_bytes(bytes(raw))
    if x == 0 and not ysign:
        return None  # identity
    y2 = (x * x * x + 3) % Q
    y = pow(y2, (Q + 1) // 4, Q)  # q = 3 mod 4
    if y * y % Q != y2:
        raise errors.TranscriptError("point not on curve (no sqrt)")
    if (y & 1) != ysign:
        y = Q - y
    return (x, y)


def g1_to_bytes_evm(pt) -> bytes:
    if pt is None:
        raise errors.TranscriptError("identity not representable in EVM words")
    x, y = pt
    return int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")


def g1_from_bytes_evm(b: bytes):
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:64], "big")
    if x >= Q or y >= Q:
        raise errors.TranscriptError("Invalid coordinate encoding in proof")
    if (y * y - (x * x * x + 3)) % Q != 0:
        raise errors.TranscriptError("point not on curve")
    return (x, y)


# --------------------------------------------------------------- proof codec


def _point_split(protocol: PlonkProtocol, scheme_name: str) -> Tuple[int, int]:
    """(points read before the evaluations, points read after them) in the
    transcript order of `PlonkProof.read`."""
    from .snark import proof_shape

    pre = sum(protocol.num_witness) + protocol.quotient.num_chunk()
    _, total = proof_shape(protocol, scheme_name)
    return pre, total - pre


def _codecs(fmt: str):
    """(point encoder, point decoder, point size, scalar encoder, scalar
    decoder) of a format: "poseidon", and the EVM codec for any other name,
    as the JAX package reads `fmt` (`sdk/proof_io.py:127-129`, `:149-153`)."""
    if fmt == "poseidon":
        return g1_to_bytes, g1_from_bytes, 32, fr_to_bytes, fr_from_bytes
    return (g1_to_bytes_evm, g1_from_bytes_evm, 64, lambda v: int(v).to_bytes(32, "big"),
            lambda b: fr_from_bytes(bytes(reversed(b))))


def proof_to_bytes(snark, scheme_name: str = "shplonk", fmt: str = "poseidon") -> bytes:
    """A Snark's streams -> its proof bytes in transcript order."""
    pre, post = _point_split(snark.protocol, scheme_name)
    if len(snark.points) != pre + post:
        raise ValueError(f"proof_to_bytes: {len(snark.points)} points, the protocol reads "
                         f"{pre + post}")
    enc_pt, _, _, enc_fr, _ = _codecs(fmt)
    out = bytearray()
    for pt in snark.points[:pre]:
        out += enc_pt(pt)
    for s in snark.scalars:
        out += enc_fr(s)
    for pt in snark.points[pre:]:
        out += enc_pt(pt)
    return bytes(out)


def proof_from_bytes(protocol: PlonkProtocol, instances: List[List[int]], data: bytes,
                     scheme_name: str = "shplonk", fmt: str = "poseidon"):
    """Proof bytes in transcript order -> a validated Snark."""
    from .snark import Snark, proof_shape

    n_scalars, _ = proof_shape(protocol, scheme_name)
    pre, post = _point_split(protocol, scheme_name)
    _, dec_pt, pt_size, _, dec_fr = _codecs(fmt)
    want = (pre + post) * pt_size + n_scalars * 32
    if len(data) != want:
        raise errors.TranscriptError(f"proof length {len(data)} != {want}")
    pos = 0
    points, scalars = [], []
    for _ in range(pre):
        points.append(dec_pt(data[pos : pos + pt_size]))
        pos += pt_size
    for _ in range(n_scalars):
        scalars.append(dec_fr(data[pos : pos + 32]))
        pos += 32
    for _ in range(post):
        points.append(dec_pt(data[pos : pos + pt_size]))
        pos += pt_size
    return Snark(protocol=protocol, instances=instances, scalars=scalars,
                 points=points).validate()
