"""The port's bincode codecs (`sdk/bincode_io.py`) against the JAX
package's: byte-equal encodings of the same protocol, instances and Snark
under both field codecs, round trips, the refusals of non-canonical scalars
and off-curve points, and a decoded snark accepted by the port's python-int
verifier."""

import copy

import pytest
import torch

from snark_verifier_tpu.sdk import bincode_io as jbio
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as jtoy_srs
from snark_verifier_tpu.system import standard_plonk as jsp

from snark_verifier_tpu_torch.ff.spec import FQ, FR
from snark_verifier_tpu_torch.sdk import bincode_io as bio
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system import standard_plonk as sp
from snark_verifier_tpu_torch.verifier.plonk.verifier import verify_snark_native

torch.set_num_threads(1)

# the first preprocessed point: after the Domain (2 usize + 3 Fr = 112 bytes)
# and the Vec's length prefix (8)
FIRST_POINT = 112 + 8


@pytest.fixture(scope="module")
def setup():
    """StandardPlonk.rand(k=3, seed=21) proved by both packages' host provers."""
    srs, jsrs = toy_srs(32), jtoy_srs(32)
    c, jc = sp.StandardPlonk.rand(k=3, seed=21), jsp.StandardPlonk.rand(k=3, seed=21)
    p, jp = sp.build_protocol(c, srs, device="cpu"), jsp.build_protocol(jc, jsrs)
    snark = sp.gen_snark(c, p, srs, scheme="shplonk", device="cpu")
    jsnark = jsp.gen_snark(jc, jp, jsrs, scheme="shplonk")
    return srs, p, jp, snark, jsnark


def _variants(p, jp):
    """The protocol as built, and with a linearization strategy and an
    accumulator's 12 instance limbs named."""
    out = [(p, jp)]
    p2, jp2 = copy.deepcopy(p), copy.deepcopy(jp)
    for q in (p2, jp2):
        q.linearization = "MinusVanishingTimesQuotient"
        q.accumulator_indices = [[(0, i) for i in range(12)]]
    out.append((p2, jp2))
    return out


@pytest.mark.parametrize("codec", ["mont", "canonical"])
def test_protocol_bytes_equal_the_jax_codec_and_round_trip(setup, codec):
    _, p, jp, _, _ = setup
    for q, jq in _variants(p, jp):
        blob = bio.write_protocol(q, fe_codec=codec)
        assert blob == jbio.write_protocol(jq, fe_codec=codec)
        again = bio.read_protocol(blob, fe_codec=codec)
        assert again.content_hash() == q.content_hash()
        assert again.linearization == q.linearization
        assert again.accumulator_indices == q.accumulator_indices
        assert bio.write_protocol(again, fe_codec=codec) == blob
    assert bio.write_protocol(p, "mont") != bio.write_protocol(p, "canonical")


def test_instances_bytes_equal_the_jax_codec_and_round_trip():
    cols = [[1, 2, FR.p - 1], [], [12345678901234567890 % FR.p]]
    blob = bio.write_instances(cols)
    assert blob == jbio.write_instances(cols)
    assert bio.read_instances(blob) == cols


@pytest.mark.parametrize("codec", ["mont", "canonical"])
def test_snark_bytes_equal_the_jax_codec_and_verify(setup, codec):
    srs, _, _, snark, jsnark = setup
    assert (snark.scalars, snark.points) == (jsnark.scalars, jsnark.points)
    blob = bio.write_snark(snark, fe_codec=codec, scheme="shplonk")
    assert blob == jbio.write_snark(jsnark, fe_codec=codec, scheme="shplonk")
    again = bio.read_snark(blob, fe_codec=codec, scheme="shplonk")
    assert isinstance(again, Snark)
    assert again.protocol.content_hash() == snark.protocol.content_hash()
    assert (again.instances, again.scalars, again.points) == \
        (snark.instances, snark.scalars, snark.points)
    assert verify_snark_native(again, srs, "shplonk")
    jagain = jbio.read_snark(blob, fe_codec=codec, scheme="shplonk")
    assert isinstance(jagain, JSnark) and jagain.points == again.points


def test_primitives():
    r = bio.Reader(bytes.fromhex("03000000000000000102030100"))
    assert r.vec(r.u8) == [1, 2, 3]
    assert r.option(r.u8) == 0x00
    r.done()
    r2 = bio.Reader(bytes.fromhex("0002000000"))
    assert r2.option(r2.u8) is None
    assert r2.u32() == 2
    r2.done()
    w = bio.Writer()
    w.vec([1, 2, 3], w.u8)
    w.option(0, w.u8)
    assert w.bytes_out() == bytes.fromhex("03000000000000000102030100")
    for bad in ("0500", "02", "0300000000000000"):
        with pytest.raises(ValueError):
            rr = bio.Reader(bytes.fromhex(bad))
            rr.option(rr.u8) if bad == "0500" else rr.vec(rr.u8)
            rr.done()


@pytest.mark.parametrize("value", [FR.p, FR.p + 1, (1 << 256) - 1])
def test_noncanonical_scalars_are_refused(value):
    blob = bytearray(bio.write_instances([[1]]))
    blob[-32:] = value.to_bytes(32, "little")
    with pytest.raises(ValueError, match="non-canonical"):
        bio.read_instances(bytes(blob))
    with pytest.raises(ValueError, match="non-canonical"):
        jbio.read_instances(bytes(blob))


@pytest.mark.parametrize("codec", ["mont", "canonical"])
def test_off_curve_points_are_refused(setup, codec):
    """An off-curve preprocessed point is refused by both codecs.  The port
    raises ValueError; the JAX package raises too, by importing an
    `errors.InvalidPoint` that its errors module does not define."""
    _, _, _, snark, jsnark = setup
    blob = bytearray(bio.write_snark(snark, fe_codec=codec))
    x = 7 * (1 << 256) % FQ.p if codec == "mont" else 7  # x = 7 under either codec
    blob[FIRST_POINT : FIRST_POINT + 32] = x.to_bytes(32, "little")
    with pytest.raises(ValueError, match="off-curve"):
        bio.read_snark(bytes(blob), fe_codec=codec)
    with pytest.raises(Exception):
        jbio.read_snark(bytes(blob), fe_codec=codec)
    # the identity (0, 0) is a valid encoding
    zero = bytearray(bio.write_protocol(snark.protocol, codec))
    zero[FIRST_POINT : FIRST_POINT + 64] = bytes(64)
    assert bio.read_protocol(bytes(zero), codec).preprocessed[0] == (0, 0)
