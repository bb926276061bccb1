"""The rest of the port's host library against the JAX package and the
python-int oracles: `utils/hypercube.py`, `hash/poseidon_optimized.py`,
`utils/native.py` (the g++-built host core, compiled here from the port's
own `csrc/host/bn254.cpp`), and `utils/timing.py` (`METER`, counted by a
CPU fold and decide by the JAX package's rules; the profile's `svt::` spans)."""

import json
import random

import pytest
import torch

from snark_verifier_tpu.hash.poseidon_optimized import PoseidonOptimizedPy as JPoseidonOptimizedPy
from snark_verifier_tpu.utils import hypercube as jhypercube
from snark_verifier_tpu.utils.timing import CostMeter as JCostMeter

from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.hash.poseidon import PoseidonPy
from snark_verifier_tpu_torch.hash.poseidon_optimized import PoseidonOptimizedPy
from snark_verifier_tpu_torch.utils import hypercube, native, timing

torch.set_num_threads(1)


# ---------------------------------------------------------------- hypercube


@pytest.mark.parametrize("n", range(0, 11))
def test_hypercube_equals_the_jax_package(n):
    bh, jbh = hypercube.BooleanHypercube(n), jhypercube.BooleanHypercube(n)
    assert hypercube.primitive_poly(n) == jhypercube.primitive_poly(n)
    seq = list(bh)
    assert seq == list(jbh)
    assert sorted(seq) == list(range(1 << n))
    for b in range(1 << n):
        assert bh.next(b) == jbh.next(b) and bh.prev(b) == jbh.prev(b)
        assert bh.rotate(b, 3) == jbh.rotate(b, 3) and bh.rotate(b, -5) == jbh.rotate(b, -5)
        if b:
            assert bh.prev(bh.next(b)) == b and bh.next(bh.prev(b)) == b


def test_hypercube_reference_table_and_refusal():
    assert [hypercube.primitive_poly(n) for n in (2, 3, 4, 5, 8, 10)] == \
        [7, 11, 19, 37, 285, 1033]
    with pytest.raises(ValueError):
        hypercube.BooleanHypercube(32)


# ------------------------------------------------------ optimized Poseidon


@pytest.mark.parametrize("seed", [42, 7])
def test_optimized_poseidon_challenges_equal_both_sponges(seed):
    """Random transcripts (0 to 6 elements a squeeze, the exact-rate case
    included): the sparse-MDS sponge, the port's vanilla sponge and the JAX
    package's sparse-MDS sponge squeeze the same challenges."""
    rng = random.Random(seed)
    a, b, c = PoseidonOptimizedPy(), PoseidonPy(), JPoseidonOptimizedPy()
    for _ in range(30):
        vals = [rng.randrange(FR.p) for _ in range(rng.randrange(0, 7))]
        for s in (a, b, c):
            s.update(vals)
        ch = a.squeeze()
        assert ch == b.squeeze() == c.squeeze()
    for seq in ([], [1, 2], [1, 2, 3, 4], [0]):
        a, b = PoseidonOptimizedPy(), PoseidonPy()
        a.update(seq)
        b.update(seq)
        assert a.squeeze() == b.squeeze()


# ------------------------------------------------------------- native core


def test_native_builds_here_into_the_package_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "snark_verifier_tpu_torch"


def test_native_msm_scalar_mul_srs_powers_equal_py_ec():
    rng = random.Random(5)
    pts = py_ec.rand_points(16, seed=17)
    ks = [rng.randrange(FR.p) for _ in range(15)] + [0]
    assert native.msm(pts, ks) == py_ec.msm(pts, ks)
    assert native.msm_mt(pts, ks, nthreads=2) == py_ec.msm(pts, ks)
    assert native.msm([pts[0], py_ec.neg(pts[0])], [3, 3]) is None
    pt = pts[0]
    for k in [0, 1, 2, FR.p - 1, 123456789]:
        assert native.scalar_mul(pt, k) == py_ec.scalar_mul(pt, k)
    assert native.srs_powers(py_ec.G1_GEN, 999, 9) == \
        [py_ec.scalar_mul(py_ec.G1_GEN, pow(999, i, FR.p)) for i in range(9)]
    raw = native.enumerate_points_dev(5)
    from snark_verifier_tpu_torch.ec import to_affine_int

    assert to_affine_int(torch.from_numpy(raw.astype("int64"))) == \
        [py_ec.scalar_mul(py_ec.G1_GEN, i + 1) for i in range(5)]


# ------------------------------------------------------------ cost meter


def test_cost_meter_equals_the_jax_meter():
    m, jm = timing.CostMeter(), JCostMeter()
    for meter in (m, jm):
        meter.start("outer")
        meter.count("msm", 2)
        meter.start("inner")
        meter.count("msm_terms", 8)
        meter.count("pairing")
        meter.end("inner")
        meter.count("pairing", 2)
        meter.end("outer")
    assert m.spans == jm.spans and m.report() == jm.report()
    assert m.report() == "outer: msm=2, msm_terms=8, pairing=3\ninner: msm_terms=8, pairing=1"
    with pytest.raises(ValueError):
        m.end("outer")


def test_fold_and_decide_count_by_the_jax_rules():
    """A CPU fold of N = 4 valid accumulators (lhs = τ·rhs on a toy SRS) and
    one decide of its result: the fold counts 2 MSMs and 2·N terms, the
    decide 2 pairings; a blind pair makes it 2·(N + 1) terms."""
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.pcs.kzg.decider import decide
    from snark_verifier_tpu_torch.sdk.srs import toy_srs

    srs = toy_srs(8)
    rhs = py_ec.rand_points(4, seed=3)
    lhs = [py_ec.scalar_mul(p, srs.tau) for p in rhs]
    pairs = torch.stack([limbs_to_words(from_affine_int(lhs)),
                         limbs_to_words(from_affine_int(rhs))], 1)  # (4, 2, 3, 8)
    span = "test_fold_and_decide"
    timing.METER.start(span)
    try:
        lhs_f, rhs_f = KzgAs.fold_hierarchical(pairs)
        assert timing.METER.spans[span] == {"msm": 2, "msm_terms": 8}
        assert bool(decide(srs, lhs_f, rhs_f))
        assert timing.METER.spans[span] == {"msm": 2, "msm_terms": 8, "pairing": 2}
        r = torch.zeros(1, 8, dtype=torch.int32)  # r = 0: only the count matters here
        blind = (pairs[None, 0, 0], pairs[None, 0, 1])
        KzgAs.verify_stacked(pairs[None], {"blind": blind, "r": r})
        assert timing.METER.spans[span] == {"msm": 4, "msm_terms": 18, "pairing": 2}
    finally:
        timing.METER.end(span)
        del timing.METER.spans[span]


def test_timer_and_profile_trace(tmp_path):
    """profile_trace's Chrome trace holds the port's `svt::` spans, the
    inner inside the outer."""
    with timing.profile_trace(str(tmp_path / "trace")):
        timing._step("tree", lambda: timing._step("fold.top", lambda: torch.ones(4).sum()))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    span = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name", "").startswith("svt::")}
    assert set(span) == {"svt::tree", "svt::fold.top"}
    assert span["svt::tree"][0] <= span["svt::fold.top"][0] <= span["svt::fold.top"][1] \
        <= span["svt::tree"][1]
