"""Instance-encoded old accumulators in the port (the recursion interface):
a snark whose public instances carry a folded KZG accumulator as 12 limbs
(3 × 88 bits per coordinate) and whose protocol's `accumulator_indices`
name them, built with the JAX package's pure-Python host prover as
tests/test_recursion.py builds it, carried over through the JAX
`Snark.to_json` and the port's `Snark.from_json`.  The port's batched
succinct verifier (device="cpu", the recorded plan decoding the limbs)
returns [fresh, old] equal to the JAX package's `succinct_verify_native`;
a corrupted limb is refused by `Snark.validate` as the JAX package refuses
it; an on-curve but invalid old accumulator is decided false, as the JAX
package decides it.

The two snarks are also committed as `snark_verifier_tpu_torch/fixtures/
old_acc_{valid,bogus}.json`, for the card's checks (`chip_smoke.py`,
`tests/test_torch_gpu.py`), which run without the JAX package; a test here
holds them to the host prover's output.  Rewrite them with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_old_accumulators.py

Tolerance: exact (affine ints, accept bits)."""

import json
from pathlib import Path

import pytest
import torch

from snark_verifier_tpu.ec import py_ec as jpy_ec
from snark_verifier_tpu.ff.spec import FR
from snark_verifier_tpu.pcs.kzg.accumulation import KzgAs as JKzgAs
from snark_verifier_tpu.pcs.kzg.accumulator import accumulator_to_limbs_int
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.loader.base import TorchLoader
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

R = FR.p
FIXTURES = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agg_snark(srs, limbs, seed, check=True):
    """A StandardPlonk snark (k = 4) carrying the 12 limbs as its instances
    (c re-solved on the instance rows), its protocol naming them as one old
    accumulator (tests/test_recursion.py::_agg_circuit_with_instances)."""
    c = StandardPlonk.rand(k=4, seed=seed, num_instance=len(limbs))
    for i, v in enumerate(limbs):
        c.c[i] = (c.c[i] - (v - c.instance[i])) % R
        c.instance[i] = v
    protocol = build_protocol(c, srs)
    protocol.accumulator_indices = [[(0, j) for j in range(12)]]
    return gen_snark(c, protocol, srs, scheme="shplonk", check=check)


def _build():
    """-> (the JAX toy SRS, the valid and the bogus snark, the folded
    accumulator the valid one carries)."""
    srs_j = j_toy_srs(32)
    leaf_accs = []
    for seed in (1, 2):
        circ = StandardPlonk.rand(k=3, seed=seed)
        leaf = gen_snark(circ, build_protocol(circ, srs_j), srs_j, scheme="shplonk")
        leaf_accs.append(j_native(leaf, srs_j)[0])
    folded = JKzgAs.create_proof((srs_j.g, srs_j.g1_powers[1]), leaf_accs, JTranscriptPy())
    valid = _agg_snark(srs_j, accumulator_to_limbs_int(folded), seed=77)
    bogus = _agg_snark(srs_j, accumulator_to_limbs_int(tuple(jpy_ec.rand_points(2, seed=99))),
                       seed=78, check=False)
    return srs_j, (valid, bogus), folded


@pytest.fixture(scope="module")
def setup():
    srs_j, snarks, folded = _build()
    port = [Snark.from_json(s.to_json()) for s in snarks]
    return srs_j, toy_srs(32), snarks, port, folded


def _affine_pairs(accs):
    return [list(zip(to_affine_int(words_to_limbs(l)), to_affine_int(words_to_limbs(r))))
            for l, r in accs]


def test_old_accumulator_decoded_as_jax_native(setup):
    srs_j, srs, (valid, _), (port, _), folded = setup
    want = j_native(valid, srs_j)
    assert len(want) == 2 and want[1] == folded
    got = _affine_pairs(batch_succinct_verify([port, port], srs, device="cpu"))
    assert [lane for lane in zip(*got)] == [tuple(want)] * 2
    assert succinct_verify_native(port, srs) == want
    assert batch_verify([port], srs, device="cpu").tolist() == [True]
    # the eager loader's decode, the plan's witness
    L = TorchLoader(1, "cpu")
    limbs = [L.scalar(v) for v in port.instances[0]]
    assert _affine_pairs([L.accumulator_from_limbs(limbs)]) == [[folded]]


def test_corrupted_limb_refused_as_jax(setup):
    _, srs, (valid, _), (port, _), _ = setup
    bad_j = JSnark(valid.protocol, [list(valid.instances[0])], valid.scalars, valid.points)
    bad_j.instances[0][0] = (bad_j.instances[0][0] + 1) % R
    from snark_verifier_tpu import errors as jerrors

    with pytest.raises(jerrors.InvalidInstances):
        bad_j.validate()
    bad = Snark(port.protocol, [list(port.instances[0])], port.scalars, port.points)
    bad.instances[0][0] = (bad.instances[0][0] + 1) % R
    with pytest.raises(errors.InvalidInstances):
        bad.validate()
    with pytest.raises(errors.InvalidInstances):
        batch_succinct_verify([bad], srs, device="cpu")


def test_invalid_old_accumulator_decided_false_as_jax(setup):
    srs_j, srs, (_, bogus), (_, port_bogus), _ = setup
    assert not j_verify(bogus, srs_j)
    oks = batch_verify([port_bogus], srs, device="cpu")
    assert oks.tolist() == [False]


def test_committed_fixtures_are_the_host_provers(setup):
    _, _, snarks, _, _ = setup
    for name, s in zip(("valid", "bogus"), snarks):
        with open(FIXTURES / f"old_acc_{name}.json") as f:
            assert json.load(f) == json.loads(json.dumps(s.to_json())), name


if __name__ == "__main__":
    FIXTURES.mkdir(exist_ok=True)
    for name, s in zip(("valid", "bogus"), _build()[1]):
        with open(FIXTURES / f"old_acc_{name}.json", "w") as f:
            json.dump(s.to_json(), f)
