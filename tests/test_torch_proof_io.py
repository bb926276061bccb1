"""The port's proof byte codecs (sdk/proof_io.py) against the JAX
package's: on every committed `snark_*` and `evmsnark_*` fixture (SHPLONK)
and `gwcsnark_*` fixture (GWC19), in both formats ("poseidon": 32-byte
little-endian scalars and compressed points; "evm": big-endian words and
x ‖ y points), `proof_to_bytes` equals the JAX package's byte for byte and
`proof_from_bytes` gives the streams back; malformed bytes are refused as
the JAX package refuses them.

Tolerance: exact (bytes, ints)."""

from pathlib import Path

import pytest

from snark_verifier_tpu.sdk import proof_io as jpio
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.snark import proof_shape as j_proof_shape
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import py_ec
from snark_verifier_tpu_torch.ff import FQ, FR
from snark_verifier_tpu_torch.sdk import proof_io as pio
from snark_verifier_tpu_torch.sdk.snark import Snark, proof_shape

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
FAMILIES = [("snark", "shplonk"), ("evmsnark", "shplonk"), ("gwcsnark", "gwc")]


@pytest.fixture(scope="module")
def fixtures():
    return {(prefix, i): (Snark.load(str(FIXTURES / f"{prefix}_{i:02d}.json")),
                          JSnark.load(str(FIXTURES / f"{prefix}_{i:02d}.json")))
            for prefix, _ in FAMILIES for i in range(16)}


@pytest.mark.parametrize("fmt", ["poseidon", "evm"])
@pytest.mark.parametrize("prefix,scheme", FAMILIES)
def test_proof_bytes_match_jax_and_round_trip(fixtures, prefix, scheme, fmt):
    for i in range(16):
        ours, theirs = fixtures[(prefix, i)]
        data = pio.proof_to_bytes(ours, scheme, fmt)
        assert data == jpio.proof_to_bytes(theirs, scheme, fmt)
        back = pio.proof_from_bytes(ours.protocol, ours.instances, data, scheme, fmt)
        assert back.scalars == ours.scalars and back.points == ours.points
        assert back.instances == ours.instances


@pytest.mark.parametrize("prefix,scheme", FAMILIES)
def test_proof_shape_matches_jax(fixtures, prefix, scheme):
    ours, theirs = fixtures[(prefix, 0)]
    shape = proof_shape(ours.protocol, scheme)
    assert shape == j_proof_shape(theirs.protocol, scheme)
    assert shape == (len(ours.scalars), len(ours.points))
    assert pio._point_split(ours.protocol, scheme) == jpio._point_split(theirs.protocol, scheme)


def test_field_and_point_codecs_match_jax():
    pts = py_ec.rand_points(24, seed=4)
    for pt in pts:
        assert pio.g1_to_bytes(pt) == jpio.g1_to_bytes(pt)
        assert pio.g1_to_bytes_evm(pt) == jpio.g1_to_bytes_evm(pt)
        assert pio.g1_from_bytes(pio.g1_to_bytes(pt)) == pt
        assert pio.g1_from_bytes_evm(pio.g1_to_bytes_evm(pt)) == pt
    assert pio.g1_to_bytes(None) == bytes(32) and pio.g1_from_bytes(bytes(32)) is None
    for v in (0, 1, FR.p - 1, 0x1234567890ABCDEF << 128):
        assert pio.fr_to_bytes(v) == jpio.fr_to_bytes(v)
        assert pio.fr_from_bytes(pio.fr_to_bytes(v)) == v
        assert pio.fq_to_bytes(v) == jpio.fq_to_bytes(v)
    assert pio.fq_to_bytes(FQ.p - 1) == jpio.fq_to_bytes(FQ.p - 1)


def test_malformed_bytes_refused_as_jax(fixtures):
    ours, theirs = fixtures[("evmsnark", 0)]
    for fmt in ("poseidon", "evm"):
        data = pio.proof_to_bytes(ours, "shplonk", fmt)
        pt_size = 32 if fmt == "poseidon" else 64
        pre, _ = pio._point_split(ours.protocol, "shplonk")
        bad_scalar = bytearray(data)
        bad_scalar[pre * pt_size + (31 if fmt == "poseidon" else 0)] = 0xFF  # >= r
        for blob in (bytes(bad_scalar), data[:-1]):
            with pytest.raises(errors.TranscriptError):
                pio.proof_from_bytes(ours.protocol, ours.instances, blob, "shplonk", fmt)
            from snark_verifier_tpu import errors as jerrors

            with pytest.raises(jerrors.TranscriptError):
                jpio.proof_from_bytes(theirs.protocol, theirs.instances, blob, "shplonk", fmt)
    x, y = ours.points[0]
    with pytest.raises(errors.TranscriptError):
        pio.g1_from_bytes_evm(pio.g1_to_bytes_evm((x, (y + 1) % FQ.p)))
    with pytest.raises(errors.TranscriptError):
        pio.g1_to_bytes_evm(None)
    with pytest.raises(errors.TranscriptError):
        pio.fq_from_bytes(FQ.p.to_bytes(32, "little"))
    # any format name but "poseidon" is the EVM codec, as in the JAX package,
    # in both directions
    for name in ("keccak", "bincode"):
        blob = pio.proof_to_bytes(ours, "shplonk", name)
        assert blob == jpio.proof_to_bytes(theirs, "shplonk", name)
        assert blob == pio.proof_to_bytes(ours, "shplonk", "evm")
        back = pio.proof_from_bytes(ours.protocol, ours.instances, blob, "shplonk", name)
        jback = jpio.proof_from_bytes(theirs.protocol, theirs.instances, blob, "shplonk", name)
        assert back.scalars == ours.scalars == jback.scalars
        assert back.points == ours.points == jback.points
