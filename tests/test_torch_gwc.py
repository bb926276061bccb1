"""The port's GWC19 multiopen (pcs/kzg/multiopen.py::Gwc19 under the
recorded plan, device="cpu": every kernel's plain version) against the JAX
package's python-int verifier on the committed GWC19 fixtures
(`gwcsnark_*.json`: vanilla PLONK k=10, Poseidon transcript): two lanes'
accumulators, a batch with a proof scalar moved by one decided lane by lane,
and the port's own python-int oracle.

Tolerance: exact (affine ints, accept bits)."""

from pathlib import Path

import pytest
import torch

from snark_verifier_tpu.ff import FR as JFR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Gwc19
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params
from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def srs_pair():
    return load_params(str(FIXTURES / "srs.bin")), j_load_params(str(FIXTURES / "srs.bin"))


def _load(cls, i):
    return cls.load(str(FIXTURES / f"gwcsnark_{i:02d}.json"))


def _bumped(cls, s):
    """The proof's first scalar moved by one."""
    return cls(s.protocol, s.instances, [(s.scalars[0] + 1) % JFR.p] + s.scalars[1:], s.points)


@pytest.mark.parametrize("lanes", [(0, 1)])
def test_gwc_batch_matches_jax_native(srs_pair, lanes):
    srs, srs_j = srs_pair
    accs = batch_succinct_verify([_load(Snark, i) for i in lanes], srs, "gwc", device="cpu")
    assert len(accs) == 1
    lhs, rhs = accs[0]
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [j_native(_load(JSnark, i), srs_j, "gwc")[0] for i in lanes]


def test_gwc_bumped_scalar_decides_as_jax_native(srs_pair):
    srs, srs_j = srs_pair
    oks = batch_verify([_bumped(Snark, _load(Snark, 2)), _load(Snark, 3)], srs, "gwc",
                       device="cpu")
    want = [j_verify(_bumped(JSnark, _load(JSnark, 2)), srs_j, "gwc"),
            j_verify(_load(JSnark, 3), srs_j, "gwc")]
    assert want == [False, True]
    assert oks.tolist() == want


def test_gwc_native_oracle_matches_jax(srs_pair):
    srs, srs_j = srs_pair
    s, js = _load(Snark, 4), _load(JSnark, 4)
    assert succinct_verify_native(s, srs, "gwc") == j_native(js, srs_j, "gwc")
    assert succinct_verify_native(s, srs, "gwc") != succinct_verify_native(s, srs, "shplonk")
    assert succinct_verify_native(s, srs, "gwc", "evm") == j_native(js, srs_j, "gwc", "evm")
    with pytest.raises(ValueError):
        succinct_verify_native(s, srs, "gwc", "blake2b")


def test_gwc_plan_shape():
    """The recorded GWC19 program fits the slot file; both sides are MSMs
    (lhs over 34 bases, rhs over the 4 opening points)."""
    plan = succinct_plan(_load(Snark, 0).protocol, Gwc19, "gwc", "poseidon")
    assert plan.tape.n_slots <= 227
    ((lhs, rhs),) = plan.accs
    assert (len(lhs.scaled), len(lhs.plain), len(rhs.scaled), len(rhs.plain)) == (34, 0, 4, 0)
