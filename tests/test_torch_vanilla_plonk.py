"""The port's vanilla PLONK (`system/vanilla_plonk.py`,
`system/vanilla_fixtures.py`) against the JAX package's on `demo_spec(6)`
(the smallest size the demo circuit takes) and `demo_assignment(spec,
seed=0)`, on `toy_srs(8 << 6)`, every commitment on the CPU
(`device="cpu"`):

  * `compile_protocol` equals the JAX package's through `to_json()`;
  * `gen_snark` with seed 0 equals the JAX package's through `to_json()`
    for SHPLONK + Poseidon, GWC19 + Poseidon and SHPLONK + keccak;
  * `verify_snark_native` and `PlonkVerifier` under `NATIVE` agree with the
    JAX package's on the honest snark, one with its instance moved by one
    and one with a proof scalar moved by one: accept, reject, reject;
  * the demo circuit refuses k = 5, as the JAX package's does.

Tolerance: exact (JSON of python ints, accept bits)."""

import pytest

from snark_verifier_tpu.loader.base import NATIVE as J_NATIVE
from snark_verifier_tpu.pcs.kzg.multiopen import Bdfg21 as JBdfg21
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system import vanilla_plonk as JV
from snark_verifier_tpu.system.vanilla_fixtures import demo_assignment as j_asg
from snark_verifier_tpu.system.vanilla_fixtures import demo_spec as j_spec
from snark_verifier_tpu.transcript.poseidon_transcript import PoseidonTranscriptPy as JPos
from snark_verifier_tpu.verifier.plonk.verifier import PlonkVerifier as JPlonkVerifier
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.loader.base import NATIVE
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system import vanilla_plonk as V
from snark_verifier_tpu_torch.system.vanilla_fixtures import demo_assignment, demo_spec
from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy
from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkVerifier, verify_snark_native

K = 6
R = FR.p


@pytest.fixture(scope="module")
def case():
    srs, jsrs = toy_srs(8 << K), j_toy_srs(8 << K)
    spec, jspec = demo_spec(K), j_spec(K)
    asg, jasg = demo_assignment(spec, seed=0), j_asg(jspec, seed=0)
    p = V.compile_protocol(spec, asg.fixed, asg.copies, srs, device="cpu")
    jp = JV.compile_protocol(jspec, jasg.fixed, jasg.copies, jsrs)
    return srs, asg, p, jsrs, jasg, jp


def test_protocol_matches_jax(case):
    _, _, p, _, _, jp = case
    assert p.to_json() == jp.to_json()


@pytest.mark.parametrize("scheme,transcript", [("shplonk", "poseidon"), ("gwc", "poseidon"),
                                               ("shplonk", "evm")])
def test_snark_matches_jax(case, scheme, transcript):
    srs, asg, p, jsrs, jasg, jp = case
    sn = V.gen_snark(asg, p, srs, scheme, seed=0, transcript=transcript, device="cpu")
    jsn = JV.gen_snark(jasg, jp, jsrs, scheme, seed=0, transcript=transcript)
    assert sn.to_json() == jsn.to_json()


def _plonk_verifier(snark, srs, verifier, transcript, scheme, L):
    instances = [[v % R for v in col] for col in snark.instances]
    t = transcript(scalars=snark.scalars, points=snark.points)
    proof = verifier.read_proof(snark.protocol, instances, t, scheme, L)
    return bool(verifier.verify(srs, snark.protocol, instances, proof, scheme, L))


def test_verifiers_agree_with_jax_on_honest_and_tampered(case):
    srs, asg, p, jsrs, _, _ = case
    good = V.gen_snark(asg, p, srs, "shplonk", seed=0, check=False, device="cpu")
    moved = [(good.scalars[0] + 1) % R] + good.scalars[1:]
    snarks = [good, Snark(p, [[(good.instances[0][0] + 1) % R]], good.scalars, good.points),
              Snark(p, good.instances, moved, good.points)]
    got = [verify_snark_native(s, srs) for s in snarks]
    by_verifier = [_plonk_verifier(s, srs, PlonkVerifier, PoseidonTranscriptPy, Bdfg21, NATIVE)
                   for s in snarks]
    jsnarks = [JSnark.from_json(s.to_json()) for s in snarks]
    want = [j_verify(s, jsrs) for s in jsnarks]
    j_by_verifier = [_plonk_verifier(s, jsrs, JPlonkVerifier, JPos, JBdfg21, J_NATIVE)
                     for s in jsnarks]
    assert got == by_verifier == want == j_by_verifier == [True, False, False]


def test_demo_circuit_refuses_k5():
    with pytest.raises(IndexError):
        demo_assignment(demo_spec(5))
    with pytest.raises(IndexError):
        j_asg(j_spec(5))
