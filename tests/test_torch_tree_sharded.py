"""The port's sharded recursion tree (`sdk.tree_aggregation.
tree_aggregate_sharded` over a mesh of `["cpu"] * 4`, every kernel's plain
version) against a python-int oracle built from the JAX package, on the
JAX package's own case (tests/test_tree_aggregation.py: one StandardPlonk
k = 3 snark on `toy_srs(32)` as 8 leaves over 4 devices).  The root equals
JAX `KzgAs.create_proof` folded in the sharded structure (each device's 2
leaves' accumulators, then the fold of the 4 device accumulators) and
decides true; the run's gathers are exactly `tree_comm_inventory`'s.  The
tampered leaf is `test_torch_tree_sharded_tampered.py`.

Tolerance: exact (affine ints, accept bits)."""

import pytest
import torch

from snark_verifier_tpu.pcs.kzg.accumulation import KzgAs as JKzgAs
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.parallel import Mesh
from snark_verifier_tpu_torch.parallel.mesh import recording
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.sdk.tree_aggregation import (
    tree_aggregate_sharded, tree_comm_inventory,
)

D = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fold(pairs):
    return JKzgAs.create_proof(None, pairs, JTranscriptPy())


def _affine(pt):
    return to_affine_int(words_to_limbs(pt))


def jax_leaf():
    """The JAX tree test's leaf: StandardPlonk k = 3, seed 13, SHPLONK."""
    srs = j_toy_srs(32)
    circuit = StandardPlonk.rand(k=3, seed=13)
    return gen_snark(circuit, build_protocol(circuit, srs), srs, scheme="shplonk"), srs


@pytest.fixture(scope="module")
def run():
    snark_j, srs_j = jax_leaf()
    leaf = Snark.from_json(snark_j.to_json())
    mesh = Mesh(["cpu"] * D, ("batch",))
    timings = {}
    with recording() as ops:
        out = tree_aggregate_sharded([leaf] * 8, toy_srs(32), mesh, timings=timings)
    return out, ops, timings, mesh, leaf, (snark_j, srs_j)


def test_sharded_root_equals_oracle_and_decides(run):
    (lhs, rhs, ok), _, timings, _, _, (snark_j, srs_j) = run
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    acc = j_native(snark_j, srs_j)[0]
    shard = _fold([acc, acc])  # each device's two leaves
    assert (_affine(lhs), _affine(rhs)) == _fold([shard] * D)
    assert set(timings) == {"succinct_s", "fold_top_s", "fold_root_s", "decide_s", "stack_s",
                            "plan_s", "read_s", "gather_s", "fr_tape_s", "msm_s"}


def test_inventory_equals_the_run(run):
    _, ops, _, mesh, leaf, _ = run
    want = [{"op": "all-gather", "type": f"s32[{D},3,8]", "bytes": D * 96}] * 2
    assert ops == want
    inv = tree_comm_inventory([leaf] * 8, toy_srs(32), mesh)
    assert inv == {"ops": want, "count": 2, "total_bytes": 2 * D * 96}
    with pytest.raises(ValueError):
        tree_comm_inventory([leaf] * 6, toy_srs(32), mesh)
