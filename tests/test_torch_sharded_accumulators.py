"""The accumulators of the sharded succinct phase
(`parallel.batch_succinct_verify_sharded` on `Mesh(["cpu"] * 2)`, every
kernel's plain version) against the python-int verifier, on the JAX
package's sharded case (tests/test_sharded_verify.py: StandardPlonk k = 3
on `toy_srs(32)`, the batch [good, bad, good, good], bad the good proof
with its instance moved by one), the proofs made by the port's own prover
(`device="cpu"`):

  * the per-shard form: one list a shard, each (lhs, rhs) of (B / D, 3, 8)
    words on the CPU;
  * the shards' accumulators, concatenated lane-wise and normalised to
    affine ints, equal `succinct_verify_native` of each lane, the port's
    and the JAX package's;
  * `batch_decide_sharded` of those shards gives [True, False, True, True],
    each lane the JAX package's `verify_snark_native`.

Tolerance: exact (affine python ints, accept bits)."""

import pytest
import torch

from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.parallel import Mesh
from snark_verifier_tpu_torch.parallel.batch_verify import (
    batch_decide_sharded,
    batch_succinct_verify_sharded,
)
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system.standard_plonk import (
    StandardPlonk,
    build_protocol,
    gen_snark,
)
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_accumulators_equal_the_native_verifier():
    srs = toy_srs(32)
    base = StandardPlonk.rand(k=3, seed=42)
    good = gen_snark(base, build_protocol(base, srs, device="cpu"), srs, device="cpu")
    bad = Snark(good.protocol, [[(good.instances[0][0] + 1) % FR.p]], good.scalars, good.points)
    snarks = [good, bad, good, good]
    mesh = Mesh(["cpu"] * 2, ("batch",))

    shards = batch_succinct_verify_sharded(snarks, srs, mesh, "shplonk")
    assert len(shards) == 2
    for accs in shards:
        assert all(t.shape == (2, 3, 8) and t.device == torch.device("cpu")
                   for lhs, rhs in accs for t in (lhs, rhs))
    n_accs = len(shards[0])
    lanes = [[tuple(to_affine_int(words_to_limbs(acc[b]))
                    for acc in shards[d][a]) for a in range(n_accs)]
             for d in range(2) for b in range(2)]
    want, jwant, jbits = {}, {}, {}
    for snark in (good, bad):  # the lanes' two distinct proofs
        jsnark = JSnark.from_json(snark.to_json())
        want[id(snark)] = [tuple(a) for a in succinct_verify_native(snark, srs)]
        jwant[id(snark)] = [tuple(a) for a in j_native(jsnark, j_toy_srs(32))]
        jbits[id(snark)] = j_verify(jsnark, j_toy_srs(32))
    assert lanes == [want[id(s)] for s in snarks] == [jwant[id(s)] for s in snarks]

    bits = batch_decide_sharded(shards, srs, mesh)
    assert bits.dtype == torch.bool and bits.shape == (4,)
    assert bits.tolist() == [jbits[id(s)] for s in snarks] == [True, False, True, True]
