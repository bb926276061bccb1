"""The port's StandardPlonk and LinearizedPlonk (`system/standard_plonk.py`,
`system/linearized_plonk.py`) against the JAX package's at k = 3 on
`toy_srs(32)`, every commitment on the CPU (`device="cpu"`):

  * the protocols (`build_protocol`, `compile_protocol` of both
    linearization strategies) equal the JAX package's through `to_json()`;
  * the snarks (`gen_snark`, with its python-int self-check) equal the JAX
    package's through `to_json()` for SHPLONK and GWC19; StandardPlonk's
    `prove` also over a keccak transcript (`EvmTranscriptPy`);
  * the port's `verify_snark_native` accepts a StandardPlonk proof and
    rejects it with its instance moved by one, as the JAX package's does
    (tests/test_torch_sharded_accumulators.py runs such proofs through the
    batch verifier);
  * an unsatisfied circuit makes the prover raise.

Tolerance: exact (JSON of python ints, accept bits)."""

import pytest

from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system import linearized_plonk as JL
from snark_verifier_tpu.system import standard_plonk as JS
from snark_verifier_tpu.transcript.evm_transcript import EvmTranscriptPy as JEvm
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system import linearized_plonk as L
from snark_verifier_tpu_torch.system import standard_plonk as S
from snark_verifier_tpu_torch.transcript import EvmTranscriptPy
from snark_verifier_tpu_torch.verifier.plonk.verifier import verify_snark_native

CPU = "cpu"


@pytest.fixture(scope="module")
def standard():
    c, jc = S.StandardPlonk.rand(3, seed=7), JS.StandardPlonk.rand(3, seed=7)
    p = S.build_protocol(c, toy_srs(32), device=CPU)
    jp = JS.build_protocol(jc, j_toy_srs(32))
    return c, p, jc, jp


def test_standard_protocol_matches_jax(standard):
    c, p, jc, jp = standard
    assert p.to_json() == jp.to_json()
    assert all(type(v) is int for pt in p.preprocessed for v in pt)


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_standard_snark_matches_jax(standard, scheme):
    c, p, jc, jp = standard
    sn = S.gen_snark(c, p, toy_srs(32), scheme, device=CPU)
    assert sn.to_json() == JS.gen_snark(jc, jp, j_toy_srs(32), scheme).to_json()


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_standard_keccak_proof_matches_jax(standard, scheme):
    c, p, jc, jp = standard
    got = S.prove(c, p, toy_srs(32), scheme, transcript=EvmTranscriptPy(), device=CPU)
    assert got == JS.prove(jc, jp, j_toy_srs(32), scheme, transcript=JEvm())


def test_standard_snark_verifies_natively(standard):
    c, p, jc, jp = standard
    good = S.gen_snark(c, p, toy_srs(32), "gwc", check=False, device=CPU)
    bad = Snark(p, [[(good.instances[0][0] + 1) % FR.p]], good.scalars, good.points)
    got = [verify_snark_native(s, toy_srs(32), "gwc") for s in (good, bad)]
    jgot = [j_verify(JSnark.from_json(s.to_json()), j_toy_srs(32), "gwc") for s in (good, bad)]
    assert got == jgot == [True, False]


def test_unsatisfied_circuit_raises(standard):
    c, p, _, _ = standard
    broken = S.StandardPlonk(**{**vars(c), "c": [(v + 1) % FR.p for v in c.c]})
    with pytest.raises(ValueError, match="unsatisfied"):
        S.prove(broken, p, toy_srs(32), device=CPU)


@pytest.mark.parametrize("strategy", [L.MINUS_VANISHING, L.WITHOUT_CONSTANT])
@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_linearized_matches_jax(strategy, scheme):
    c, jc = L.LinearizedPlonk.rand(3, seed=11), JL.LinearizedPlonk.rand(3, seed=11)
    p = L.compile_protocol(c, toy_srs(32), strategy, device=CPU)
    jp = JL.compile_protocol(jc, j_toy_srs(32), strategy)
    assert p.to_json() == jp.to_json()
    sn = L.gen_snark(c, p, toy_srs(32), scheme, device=CPU)
    assert sn.to_json() == JL.gen_snark(jc, jp, j_toy_srs(32), scheme).to_json()
