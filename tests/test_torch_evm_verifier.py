"""The port's EVM verifier generator and Yul interpreter against the JAX
package's (`loader/evm_loader.py`, `loader/yul_interp.py`, `sdk/evm.py`,
`verifier/cost.py`): the same Yul text character for character, the same
estimates, the same gas_used on the same calldata, the same verdicts.  Host
code on both sides: nothing here runs a kernel."""

import copy
import math

import pytest
import torch

from snark_verifier_tpu import errors as jerrors
from snark_verifier_tpu.loader import yul_interp as jyul
from snark_verifier_tpu.sdk import evm as jevm
from snark_verifier_tpu.sdk.proof_io import proof_to_bytes as jproof_to_bytes
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as jtoy_srs
from snark_verifier_tpu.system import standard_plonk as jsp
from snark_verifier_tpu.transcript import EvmTranscriptPy as JEvmTranscriptPy
from snark_verifier_tpu.verifier import cost as jcost

from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.loader import yul_interp
from snark_verifier_tpu_torch.sdk import evm
from snark_verifier_tpu_torch.sdk.proof_io import proof_to_bytes
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system import standard_plonk as sp
from snark_verifier_tpu_torch.transcript.evm_transcript import EvmTranscriptPy
from snark_verifier_tpu_torch.verifier import cost

torch.set_num_threads(1)

EIP170_LIMIT = 24576


@pytest.fixture(scope="module")
def both():
    """StandardPlonk.rand(k=3, seed=11) on toy_srs(32) in both packages."""
    jsrs, srs = jtoy_srs(32), toy_srs(32)
    jc, c = jsp.StandardPlonk.rand(k=3, seed=11), sp.StandardPlonk.rand(k=3, seed=11)
    return jsrs, jc, jsp.build_protocol(jc, jsrs), srs, c, sp.build_protocol(c, srs, device="cpu")


def _proofs(both, scheme):
    """The same keccak proof from each package's host prover -> (instances,
    the port's bytes, the JAX package's bytes)."""
    jsrs, jc, jp, srs, c, p = both
    sc, pts = sp.prove(c, p, srs, scheme=scheme, transcript=EvmTranscriptPy(), device="cpu")
    jsc, jpts = jsp.prove(jc, jp, jsrs, scheme=scheme, transcript=JEvmTranscriptPy())
    snark = Snark(p, [list(c.instance)], sc, pts)
    jsnark = JSnark(jp, [list(jc.instance)], jsc, jpts)
    return snark.instances, proof_to_bytes(snark, scheme, fmt="evm"), jproof_to_bytes(
        jsnark, scheme, fmt="evm")


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_yul_and_estimates_equal_the_jax_package(both, scheme):
    jsrs, _, jp, srs, _, p = both
    yul, rep = evm.gen_evm_verifier_report(p, srs, scheme)
    jyul_text, jrep = jevm.gen_evm_verifier_report(jp, jsrs, scheme)
    assert yul == jyul_text
    assert rep == jrep
    assert rep["estimated_code_size"] <= EIP170_LIMIT
    assert cost.estimate_plonk_cost(p, scheme).__dict__ == \
        jcost.estimate_plonk_cost(jp, scheme).__dict__
    assert cost.estimate_plonk_cost(p, scheme, succinct_only=True).__dict__ == \
        jcost.estimate_plonk_cost(jp, scheme, succinct_only=True).__dict__


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_gas_and_verdicts_equal_the_jax_interpreter(both, scheme):
    _, _, _, srs, _, p = both
    yul = evm.gen_evm_verifier(p, srs, scheme)
    instances, proof, jproof = _proofs(both, scheme)
    assert proof == jproof
    gas = evm.evm_verify(yul, instances, proof)
    assert gas == jevm.evm_verify(yul, instances, proof)
    assert gas > 100_000  # two pairings alone are 113k
    cd = evm.encode_calldata(instances, proof)
    assert yul_interp.execute_yul(yul, cd) == jyul.execute_yul(yul, cd)

    bad_inst = [[(instances[0][0] + 1) % FR.p]]
    with pytest.raises(errors.AssertionFailure):
        evm.evm_verify(yul, bad_inst, proof)
    with pytest.raises(jerrors.AssertionFailure):
        jevm.evm_verify(yul, bad_inst, proof)
    cd_bad = evm.encode_calldata(bad_inst, proof)
    assert yul_interp.execute_yul(yul, cd_bad) == jyul.execute_yul(yul, cd_bad)

    # a flipped proof byte (challenge divergence) and an off-curve witness
    # point (validate_ec_point): both revert, at the JAX package's gas
    for pos in (1, 31):
        bad = bytearray(proof)
        bad[pos] ^= 1
        cd = evm.encode_calldata(instances, bytes(bad))
        ok, g, data = yul_interp.execute_yul(yul, cd)
        assert not ok
        assert (ok, g, data) == jyul.execute_yul(yul, cd)


_PROGRAMS = {
    "basics": """object "t" { object "Runtime" { code {
        let x := 5
        let y := add(x, 0x10)
        mstore(0x00, mulmod(y, 3, 7))
        if iszero(eq(mload(0x00), 0)) { mstore(0x20, 1) }
        return(0x20, 0x20)
    } } }""",
    "branches": """object "t" { object "Runtime" { code {
        mstore(0x00, 42)
        if eq(mload(0x00), 42) { mstore(0x20, 7) }
        if eq(mload(0x00), 43) { mstore(0x40, 9) }
        return(0x20, 0x40)
    } } }""",
    "ec_add": """object "t" { object "Runtime" { code {
        mstore(0x00, 1)
        mstore(0x20, 2)
        mstore(0x40, 1)
        mstore(0x60, 2)
        let ok := staticcall(gas(), 0x6, 0x00, 0x80, 0x80, 0x40)
        if iszero(ok) { revert(0, 0) }
        return(0x80, 0x40)
    } } }""",
    "ec_add_off_curve": """object "t" { object "Runtime" { code {
        mstore(0x00, 1)
        mstore(0x20, 3)
        mstore(0x40, 1)
        mstore(0x60, 2)
        let ok := staticcall(gas(), 0x6, 0x00, 0x80, 0x80, 0x40)
        if iszero(ok) { revert(0, 0) }
        return(0x80, 0x40)
    } } }""",
    "ec_mul_and_identity": """object "t" { object "Runtime" { code {
        mstore(0x00, 1)
        mstore(0x20, 2)
        mstore(0x40, 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001)
        let ok := staticcall(gas(), 0x7, 0x00, 0x60, 0x80, 0x40)
        mstore(0xc0, 0)
        mstore(0xe0, 0)
        mstore(0x100, 1)
        mstore(0x120, 2)
        ok := and(ok, staticcall(gas(), 0x6, 0xc0, 0x80, 0x140, 0x40))
        if iszero(ok) { revert(0, 0) }
        return(0x80, 0x100)
    } } }""",
    "ec_out_of_range_word": """object "t" { object "Runtime" { code {
        mstore(0x00, 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd48)
        mstore(0x20, 2)
        mstore(0x40, 3)
        let ok := staticcall(gas(), 0x7, 0x00, 0x60, 0x80, 0x40)
        if iszero(ok) { revert(0, 0) }
        return(0x80, 0x40)
    } } }""",
    "modexp_and_keccak": """object "t" { object "Runtime" { code {
        function inv(a) -> r {
            mstore(0x200, 0x20)
            mstore(0x220, 0x20)
            mstore(0x240, 0x20)
            mstore(0x260, a)
            mstore(0x280, 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593efffffff)
            mstore(0x2a0, 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001)
            pop(staticcall(gas(), 0x5, 0x200, 0xc0, 0x2c0, 0x20))
            r := mload(0x2c0)
        }
        mstore(0x00, inv(calldataload(0x00)))
        mstore(0x20, keccak256(0x00, 0x21))
        mstore8(0x40, 0xff)
        return(0x00, 0x60)
    } } }""",
    "pairing_identity_pairs": """object "t" { object "Runtime" { code {
        let ok := staticcall(gas(), 0x8, 0x00, 0x180, 0x00, 0x20)
        if iszero(ok) { revert(0, 0) }
        return(0x00, 0x20)
    } } }""",
    "pairing_bad_length": """object "t" { object "Runtime" { code {
        let ok := staticcall(gas(), 0x8, 0x00, 0x100, 0x00, 0x20)
        if iszero(ok) { revert(0, 0) }
        return(0x00, 0x20)
    } } }""",
}


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_interpreter_equals_the_jax_interpreter(name):
    src = _PROGRAMS[name]
    cd = (12345).to_bytes(32, "big") + b"\x00\x07"
    got = yul_interp.execute_yul(src, cd)
    assert got == jyul.execute_yul(src, cd)
    assert yul_interp.tokenize(src) == jyul.tokenize(src)
    ok, _gas, data = got
    if name == "basics":
        assert ok and data == b"\x00" * 32  # (5 + 0x10)·3 % 7 == 0: no branch
    if name == "branches":
        assert ok and int.from_bytes(data[:32], "big") == 7 and data[32:] == b"\x00" * 32
    if name == "ec_add":
        from snark_verifier_tpu_torch.ec import py_ec

        g2 = py_ec.add((1, 2), (1, 2))
        assert ok and data == g2[0].to_bytes(32, "big") + g2[1].to_bytes(32, "big")
    if name in ("ec_add_off_curve", "ec_out_of_range_word", "pairing_bad_length"):
        assert not ok  # the precompile refuses: staticcall 0 -> revert
    if name == "ec_mul_and_identity":
        assert ok and data[:64] == b"\x00" * 64  # r·G is the identity
    if name == "pairing_identity_pairs":
        assert ok and int.from_bytes(data, "big") == 1


def test_calldata_and_gas_model_equal_the_jax_package():
    cd = evm.encode_calldata([[1, 2], [3]], b"\xAA\xBB")
    assert cd == jevm.encode_calldata([[1, 2], [3]], b"\xAA\xBB")
    assert len(cd) == 3 * 32 + 2 and cd[31] == 1 and cd[63] == 2 and cd[95] == 3
    for kw in (dict(num_instance=4, num_commitment=10, num_evaluation=20, num_msm=15,
                    num_pairing=2), dict(num_commitment=2, num_msm=2), {}):
        c, jc = cost.Cost(**kw), jcost.Cost(**kw)
        assert evm.estimate_gas(c) == jevm.estimate_gas(jc)
    c = cost.Cost(num_instance=4, num_commitment=10, num_evaluation=20, num_msm=15,
                  num_pairing=2)
    proof_size = 10 * 64 + (20 + 4) * 32
    assert evm.estimate_gas(c) == (21000 + math.ceil(proof_size * 15.25) + 45100 + 2 * 34000
                                   + 13 * 6350)
    assert (c + c).num_msm == 30


def test_instance_committing_key_protocol_is_refused(both):
    jsrs, _, jp, srs, _, p = both
    p2, jp2 = copy.deepcopy(p), copy.deepcopy(jp)
    ick = {"bases": srs.g1_powers[:1], "constant": None}
    p2.instance_committing_key, jp2.instance_committing_key = ick, dict(ick)
    with pytest.raises(errors.InvalidProtocol):
        evm.gen_evm_verifier(p2, srs, "shplonk")
    with pytest.raises(AssertionError):
        jevm.gen_evm_verifier(jp2, jsrs, "shplonk")


def _accumulator_snark(srs, limbs, scheme="shplonk"):
    """A StandardPlonk k = 4 snark whose 12 instances are `limbs`, proved
    with the keccak transcript, its protocol naming them an accumulator."""
    circ = sp.StandardPlonk.rand(k=4, seed=23, num_instance=12)
    for i, v in enumerate(limbs):
        delta = (v - circ.instance[i]) % FR.p
        circ.c[i] = (circ.c[i] - delta) % FR.p
        circ.instance[i] = v
    protocol = sp.build_protocol(circ, srs, device="cpu")
    protocol.accumulator_indices = [[(0, j) for j in range(12)]]
    sc, pts = sp.prove(circ, protocol, srs, scheme=scheme, transcript=EvmTranscriptPy(),
                       device="cpu")
    return Snark(protocol, [list(circ.instance)], sc, pts)


def test_evm_verifier_with_accumulator():
    """The JAX package's test_evm_verifier_with_accumulator on the port: a
    snark carrying a folded accumulator in its instances gets a verifier that
    decodes the limbs (shl-composition + on-curve validation) and decides
    both accumulators with the keccak-RLC fold, one pairing; its Yul equals
    the JAX generator's for the same protocol."""
    from snark_verifier_tpu.sdk.bincode_io import read_protocol as jread_protocol

    from snark_verifier_tpu_torch.ec import py_ec
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.pcs.kzg.accumulator import accumulator_to_limbs_int
    from snark_verifier_tpu_torch.sdk.bincode_io import write_protocol
    from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

    srs = toy_srs(32)
    leaf_accs = []
    for seed in (21, 22):
        circ = sp.StandardPlonk.rand(k=3, seed=seed)
        proto = sp.build_protocol(circ, srs, device="cpu")
        sc, pts = sp.prove(circ, proto, srs, scheme="shplonk", transcript=PoseidonTranscriptPy(),
                           device="cpu")
        leaf = Snark(proto, [list(circ.instance)], sc, pts)
        leaf_accs.append(succinct_verify_native(leaf, srs, "shplonk")[0])
    folded = KzgAs.create_proof((srs.g, srs.g1_powers[1]), leaf_accs, PoseidonTranscriptPy())
    snark = _accumulator_snark(srs, accumulator_to_limbs_int(folded))
    proof = proof_to_bytes(snark, "shplonk", fmt="evm")

    yul = evm.gen_evm_verifier(snark.protocol, srs, "shplonk")
    jprotocol = jread_protocol(write_protocol(snark.protocol))
    assert yul == jevm.gen_evm_verifier(jprotocol, jtoy_srs(32), "shplonk")
    assert yul.count("staticcall(gas(), 0x8") == 1  # the RLC fold: one pairing
    gas = evm.evm_verify(yul, snark.instances, proof)
    assert gas == jevm.evm_verify(yul, snark.instances, proof)

    # a corrupted limb fails validate_ec_point on the decoded point
    bad = [list(snark.instances[0])]
    bad[0][0] = (bad[0][0] + 1) % FR.p
    with pytest.raises(errors.AssertionFailure):
        evm.evm_verify(yul, bad, proof)

    # an on-curve but invalid old accumulator fails the pairing
    snark2 = _accumulator_snark(srs, accumulator_to_limbs_int(tuple(py_ec.rand_points(2, seed=77))))
    yul2 = evm.gen_evm_verifier(snark2.protocol, srs, "shplonk")
    with pytest.raises(errors.AssertionFailure):
        evm.evm_verify(yul2, snark2.instances, proof_to_bytes(snark2, "shplonk", fmt="evm"))
