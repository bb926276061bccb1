"""The parts the configuration evm-accumulator-agg-k8 and the cells
verify-evm-agg-b1024 and msm-k21-witness add, on the CPU: the fixtures
are the copies their manifest names (the SRS the bytes of the first
configuration's), 1,024 distinct proofs of the published shape; the
witness traffic keeps its mix; the verify cell and the witness cell run
whole at a tiny size and come out correct, a batch with a refused lane
among them, and their controls do not."""

import hashlib
import json
import time

import pytest
import torch

from harness import cli
from harness.catalog import BENCH_DIR, Catalog
from harness.entries import msm_witness
from reference.fields import FR

FIX = BENCH_DIR / "fixtures_evm_accumulator"


def test_the_new_fixtures_match_their_manifest():
    man = json.loads((FIX / "MANIFEST.json").read_text())["sha256"]
    files = {p.name for p in FIX.iterdir() if p.name != "MANIFEST.json"}
    assert files == set(man) and len(files) == 3
    for name, digest in man.items():
        assert hashlib.sha256((FIX / name).read_bytes()).hexdigest() == digest
    assert (FIX / "srs_k8.bin").read_bytes() == (BENCH_DIR / "fixtures" / "srs_k8.bin").read_bytes()


def test_the_pool_is_1024_distinct_proofs_of_the_published_shape():
    cfg = Catalog().config("evm-accumulator-agg-k8")
    fx = cfg["fixtures"]
    protocol = json.loads((FIX / fx["protocol"]).read_text())
    assert protocol["accumulator_indices"] == [[[0, i] for i in range(12)]]
    assert protocol["num_instance"] == [12] and len(protocol["preprocessed"]) == 15
    assert sorted({q["rotation"] for q in protocol["queries"]}) == [-6, -1, 0, 1, 2, 3]
    lines = (FIX / fx["pools"]["evm"]).read_text().splitlines()
    assert len(lines) == fx["count"] == 1024 and len(set(lines)) == 1024
    row = json.loads(lines[0])
    assert (len(row["scalars"]), len(row["points"])) == (53, 19)


def _classes(col):
    """Row shares: zero, one, other values below 2^20, below 2^88, the rest."""
    v = col.to(torch.int64)
    zero = (v == 0).all(1)
    one = (v[:, 0] == 1) & (v[:, 1:] == 0).all(1)
    lt20 = (v[:, 2:] == 0).all(1) & (v[:, 1] < 16) & ~zero & ~one
    lt88 = (v[:, 6:] == 0).all(1) & (v[:, 5] < 256) & ~lt20 & ~zero & ~one
    n = v.shape[0]
    return [float(x.sum()) / n for x in (zero, one, lt20, lt88)]


def test_the_witness_vectors_keep_their_mix():
    traffic = Catalog().traffic("witness-x6")
    n = 1 << 19
    cols = msm_witness.make_witness_scalars(n, traffic, 2**31 + 77, "cpu")
    assert len(cols) == 6 and all(c.shape == (n, 16) for c in cols)
    r = sum(int(x) << (16 * i) for i, x in enumerate(msm_witness.msm_commit.R_LIMBS.tolist()))
    assert r == FR.p
    adv = traffic["advice"]
    want = [adv["zero"], adv["one"], adv["below_2_20"], adv["below_2_88"]]
    for col in cols[:5]:
        got = _classes(col)
        assert all(abs(g - w) < 0.005 for g, w in zip(got, want)), (got, want)
        top = col[:, 12] | (col[:, 13] << 16) | (col[:, 14] << 32) | (col[:, 15] << 48)
        r_top = sum(int(msm_witness.msm_commit.R_LIMBS[12 + j]) << (16 * j) for j in range(4))
        assert bool((top < r_top).all())  # canonical
        same = (col[1:] == col[:-1]).all(1).float().mean().item()
        assert abs(same - 0.61) < 0.01  # runs of 1-4 rows: 1.5 repeats in 2.5; 1% zero-zero or one-one
    z, one, lt20, lt88 = _classes(cols[5])
    assert abs(z - traffic["lookup"]["zero"]) < 0.005 and abs(lt20 + one - 0.9) < 0.005
    assert lt88 == 0
    again = msm_witness.make_witness_scalars(n, traffic, 2**31 + 77, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(cols, again))


def _run(cell, traffic, config=None, control=False):
    cat = Catalog()
    config = config or cat.config(cat.cell(cell)["config"])
    result, _ = cli.run_cell(cell, 2**31 + 4242, 0.01, False, time.perf_counter(), catalog=cat,
                             device="cpu", traffic=traffic, config=config, check_card=False,
                             control=control)
    return result


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_verify_cell_runs_whole_at_a_tiny_size(control):
    traffic = {"kind": "proof_lanes", "transcript": "evm", "lanes": 4, "batches": 1,
               "tampered_batches": 1, "tampers_per_batch": 3, "tamper_variants": 3,
               "kinds": ["instance", "scalar", "point"]}
    result = _run("verify-evm-agg-b1024", traffic, control=control)
    assert result["correct"] is (not control), result["checks"]
    assert "verify_proofs_per_s" in result["metrics"] and "setup_s" in result["metrics"]


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_witness_cell_runs_whole_at_a_tiny_size(control):
    cat = Catalog()
    config = dict(cat.config("agg-k21-commit"), n=2048)
    traffic = dict(cat.traffic("witness-x6"), vectors=2, columns={"advice": 1, "lookup_advice": 1})
    result = _run("msm-k21-witness", traffic, config, control=control)
    assert result["correct"] is (not control), result["checks"]
    assert "msm_points_per_s" in result["metrics"]
