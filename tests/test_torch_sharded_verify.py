"""The port's sharded batch verify (`parallel.batch_verify_sharded` over a
mesh of `["cpu"] * 2`, every kernel's plain version) on the JAX package's
own case (tests/test_sharded_verify.py: StandardPlonk k = 3 on
`toy_srs(32)`, the batch [good, bad, good, good] over 2 devices, bad the
good proof with its instance moved by one): [True, False, True, True],
lane for lane equal to the port's one-device `batch_verify` and to the JAX
package's python-int `verify_snark_native`.

Tolerance: exact (accept bits)."""

import pytest
import torch

from snark_verifier_tpu.ff.spec import FR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native
from snark_verifier_tpu_torch.parallel import Mesh, batch_verify, batch_verify_sharded
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    srs = j_toy_srs(32)
    base = StandardPlonk.rand(k=3, seed=42)
    good = gen_snark(base, build_protocol(base, srs), srs, scheme="shplonk")
    bad = JSnark(protocol=good.protocol, instances=[[(good.instances[0][0] + 1) % FR.p]],
                 scalars=good.scalars, points=good.points)
    snarks_j = [good, bad, good, good]
    want = [verify_snark_native(s, srs) for s in snarks_j]
    return [Snark.from_json(s.to_json()) for s in snarks_j], want


def test_sharded_verify_equals_one_device_and_jax_native(case):
    snarks, want = case
    assert want == [True, False, True, True]
    mesh = Mesh(["cpu"] * 2, ("batch",))
    timings = {}
    oks = batch_verify_sharded(snarks, toy_srs(32), mesh, "shplonk", timings=timings)
    assert oks.dtype == torch.bool and oks.shape == (4,) and oks.device == torch.device("cpu")
    assert oks.tolist() == want
    assert oks.tolist() == batch_verify(snarks, toy_srs(32), device="cpu").tolist()
    assert set(timings) == {"succinct_s", "decide_s", "stack_s", "plan_s", "read_s",
                            "gather_s", "fr_tape_s", "msm_s"}
    assert min(timings.values()) > 0


def test_sharded_verify_refuses_an_uneven_batch(case):
    snarks, _ = case
    with pytest.raises(ValueError):
        batch_verify_sharded(snarks[:3], toy_srs(32), Mesh(["cpu"] * 2, ("batch",)))
