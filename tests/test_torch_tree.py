"""The port's aggregation and its 1-card recursion tree (sdk/aggregation.py,
sdk/tree_aggregation.py, device="cpu": every kernel's plain version) against
python-int oracles built from the JAX package: the leaves' accumulators from
`succinct_verify_native`, folded with JAX `KzgAs.create_proof` in the same
structure.  `tree_aggregate_root` over 4 committed vanilla-PLONK leaves (two
fixtures tiled) decides true and a tampered leaf decides false;
`tree_aggregate(fanout=2)` folds two groups of 2, then the root;
`aggregate_and_decide` accepts; `aggregate_heterogeneous` over two small
StandardPlonk protocols folds in the original snark order.

Tolerance: exact (affine ints, accept bits)."""

from pathlib import Path

import pytest
import torch

from snark_verifier_tpu.ff import FR as JFR
from snark_verifier_tpu.pcs.kzg.accumulation import KzgAs as JKzgAs
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.sdk.aggregation import aggregate_and_decide, aggregate_heterogeneous
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params, toy_srs
from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate, tree_aggregate_root

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"


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


@pytest.fixture(scope="module")
def leaves():
    """4 leaves (snark_00, snark_01, tiled) and their native accumulators."""
    srs_j = j_load_params(str(FIXTURES / "srs.bin"))
    names = ["snark_00.json", "snark_01.json"]
    accs = [j_native(JSnark.load(str(FIXTURES / n)), srs_j)[0] for n in names]
    base = [Snark.load(str(FIXTURES / n)) for n in names]
    return load_params(str(FIXTURES / "srs.bin")), base * 2, accs * 2


def test_tree_root_decides_and_equals_oracle(leaves):
    srs, snarks, accs = leaves
    timings = {}
    lhs, rhs, ok = tree_aggregate_root(snarks, srs, device="cpu", timings=timings)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    assert (_affine(lhs), _affine(rhs)) == _fold([_fold(accs)])
    assert {"succinct_s", "fold_top_s", "fold_root_s", "decide_s"} <= set(timings)
    assert "fold_groups_s" not in timings  # 4 accumulators fold once


def test_tree_root_rejects_a_tampered_leaf(leaves):
    srs, snarks, _ = leaves
    s = snarks[0]
    tam = Snark(s.protocol, [list(c) for c in s.instances], s.scalars, s.points)
    tam.instances[0][0] = (tam.instances[0][0] + 1) % JFR.p
    _, _, ok = tree_aggregate_root([tam] + snarks[1:], srs, device="cpu")
    assert not bool(ok)


def test_local_tree_equals_oracle(leaves):
    srs, snarks, accs = leaves
    lhs, rhs = tree_aggregate(snarks, srs, fanout=2, device="cpu")
    group = _fold(accs[:2])
    assert (_affine(lhs), _affine(rhs)) == _fold([group, group])


def test_aggregate_and_decide_accepts(leaves):
    srs, snarks, _ = leaves
    assert bool(aggregate_and_decide(snarks[:2], srs, device="cpu"))


def test_heterogeneous_folds_in_snark_order():
    srs_j = j_toy_srs(32)
    snarks = []
    for seed, k in ((5, 3), (6, 3), (5, 3)):
        circ = StandardPlonk.rand(k=k, seed=seed)
        snarks.append(gen_snark(circ, build_protocol(circ, srs_j), srs_j, scheme="shplonk"))
    assert snarks[0].protocol.content_hash() != snarks[1].protocol.content_hash()
    want = _fold([j_native(s, srs_j)[0] for s in snarks])
    port = [Snark.from_json(s.to_json()) for s in snarks]
    lhs, rhs = aggregate_heterogeneous(port, toy_srs(32), device="cpu")
    assert (_affine(lhs), _affine(rhs)) == want
