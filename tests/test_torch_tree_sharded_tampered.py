"""The port's sharded recursion tree rejects a tampered leaf: the JAX
package's case (tests/test_tree_aggregation.py: 8 leaves over 4 devices,
the last leaf's instance moved by one) through `tree_aggregate_sharded` on
a mesh of `["cpu"] * 4`, against the JAX package's python-int verifier of
the same leaf.  A file of its own: each CPU tree takes about a minute.

Tolerance: exact (accept bits)."""

import pytest
import torch

from snark_verifier_tpu.ff.spec import FR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native
from snark_verifier_tpu_torch.parallel import Mesh
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_sharded

from test_torch_tree_sharded import jax_leaf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_tree_rejects_a_tampered_leaf():
    snark_j, srs_j = jax_leaf()
    bad_j = JSnark(protocol=snark_j.protocol,
                   instances=[[(snark_j.instances[0][0] + 1) % FR.p]],
                   scalars=snark_j.scalars, points=snark_j.points)
    assert verify_snark_native(snark_j, srs_j) and not verify_snark_native(bad_j, srs_j)
    leaf, bad = (Snark.from_json(s.to_json()) for s in (snark_j, bad_j))
    _, _, ok = tree_aggregate_sharded([leaf] * 7 + [bad], toy_srs(32),
                                      Mesh(["cpu"] * 4, ("batch",)))
    assert ok.dtype == torch.bool and not bool(ok)
