"""The port's spans and counters (`utils/timing.py::_step`, `_wait`;
`_launch.COUNTERS`) on the CPU, every kernel's plain version.

With no profiler running and no `timings` dict a span is one test and the
call: it never enters torch's record function and never synchronizes.  While a
profiler runs, every step of the batch verify, the tree, the fold levels
and the MSM is a span named "svt::<layer>.<step>" nested under its call's
outer span (`svt::verify`, `svt::tree`, `svt::msm`): checked in a real
torch.profiler run of a small MSM, and, for the verify and the tree, whose
plain paths run too many small operations for a CPU profile of them to
stay short, through the same record-function entry point with a
recorder in the profiler's place.  Every `_wait` is one span and one count
of `host_waits`; a batch's inputs go up as one upload (`svt::verify.upload`,
one count of `packed_uploads`) with no wait; an MSM whose digits crowd one
bucket counts its retry.

Tolerance: exact (names, nesting, counts, accept bits)."""

import contextlib

import pytest
import torch

from snark_verifier_tpu_torch import _launch
from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec, to_affine_int
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.msm.pippenger import msm_checked, scalars_from_int
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_root
from snark_verifier_tpu_torch.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
from snark_verifier_tpu_torch.utils import timing

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refuse(*args, **kwargs):
    raise AssertionError("a span with nothing on must not get here")


def _points(n):
    return from_affine_int([py_ec.scalar_mul(py_ec.G1_GEN, i + 1) for i in range(n)])


class _Recorder:
    """Stands in for torch's record function (`timing._record`) while a
    profiler "runs": every span's name and the names of the spans open around it,
    outermost first."""

    def __init__(self):
        self.open, self.spans = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        self.spans.append((name, tuple(self.open)))
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()

    def names(self):
        return {n for n, _ in self.spans}

    def parents(self, name):
        return {outer[-1] if outer else None for n, outer in self.spans if n == name}


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(timing, "_record", rec)
    return rec


@pytest.fixture(scope="module")
def proofs():
    """A StandardPlonk k = 3 proof on toy_srs(32) (the port's host prover)
    and a copy with its instance moved by one."""
    srs = toy_srs(32)
    circuit = StandardPlonk.rand(k=3, seed=42)
    good = gen_snark(circuit, build_protocol(circuit, srs, device="cpu"), srs, scheme="shplonk",
                     device="cpu")
    bad = Snark(good.protocol, [[(good.instances[0][0] + 1) % FR.p]], good.scalars, good.points)
    return srs, good, bad


def _waits_match_their_count(rec):
    waits = [n for n, _ in rec.spans if n.startswith("svt::wait.")]
    assert waits and _launch.COUNTERS["host_waits"] == len(waits)


def test_a_span_with_nothing_on_never_records_and_never_synchronizes(monkeypatch):
    monkeypatch.setattr(timing, "_record", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(timing, "_synchronize", _refuse)
    assert timing._step("verify.plan", lambda: 7) == 7
    assert timing._step("verify.plan", lambda: 7, {}, None, CPU) == 7  # a dict, no key
    assert timing._step("verify.plan", lambda: 7, None, "plan_s", CPU) == 7  # a key, no dict
    _launch.reset_launches()
    assert timing._wait("msm_digits", lambda: 8) == 8
    assert _launch.COUNTERS["host_waits"] == 1
    out = msm_checked(_points(4), scalars_from_int([5, 6, 7, 8]), c=4, device="cpu")
    assert out.shape == (3, 16) and _launch.COUNTERS["msm_attempts"] == 1


def test_a_step_with_a_timings_key_synchronizes_and_adds_its_seconds(monkeypatch):
    seen = []
    monkeypatch.setattr(timing, "_synchronize", seen.append)
    timings = {}
    for _ in range(2):
        assert timing._step("verify.read", lambda: 3, timings, "read_s", "mesh") == 3
    timing._step("verify.streams", lambda: None, timings)  # no key: nothing added
    assert seen == ["mesh"] * 4 and set(timings) == {"read_s"} and timings["read_s"] >= 0


def test_batch_verify_spans_nest_under_svt_verify(proofs, recorder):
    srs, good, bad = proofs
    _launch.reset_launches()
    assert batch_verify([good, bad], srs, device="cpu").tolist() == [True, False]
    steps = {"plan", "stack", "streams", "instances", "read", "gather", "fr_tape", "msm",
             "succinct", "decide"}
    assert {f"svt::verify.{s}" for s in steps} <= recorder.names()
    assert recorder.parents("svt::verify") == {None}
    assert all(outer[0] == "svt::verify" for n, outer in recorder.spans if n != "svt::verify")
    assert recorder.parents("svt::verify.streams") == {"svt::verify.stack"}
    assert recorder.parents("svt::verify.instances") == {"svt::verify.stack"}
    assert recorder.parents("svt::verify.plan") == {"svt::verify.succinct"}
    assert recorder.parents("svt::verify.decide") == {"svt::verify"}
    assert recorder.parents("svt::verify.upload") == {"svt::verify.stack"}
    assert not {"svt::wait.stack_scalars", "svt::wait.stack_points",
                "svt::wait.instances"} & recorder.names()
    assert _launch.COUNTERS["packed_uploads"] == 1
    assert recorder.parents("svt::wait.msm_rows") == {"svt::verify.msm"}
    _waits_match_their_count(recorder)


def test_tree_spans_nest_under_svt_tree(proofs, recorder):
    srs, good, _ = proofs
    _launch.reset_launches()
    _, _, ok = tree_aggregate_root([good, good], srs, device="cpu")
    assert bool(ok)
    assert {"svt::tree", "svt::tree.succinct", "svt::fold.top", "svt::fold.root",
            "svt::fold.read", "svt::fold.verify", "svt::tree.decide",
            "svt::verify.plan", "svt::verify.msm"} <= recorder.names()
    assert all(outer[0] == "svt::tree" for n, outer in recorder.spans if n != "svt::tree")
    assert recorder.parents("svt::verify.plan") == {"svt::tree.succinct"}
    assert recorder.parents("svt::fold.root") == {"svt::tree"}
    assert recorder.parents("svt::fold.top") == {"svt::tree", "svt::fold.root"}
    assert recorder.parents("svt::fold.read") == {"svt::fold.top"}
    assert recorder.parents("svt::wait.sponge_init") >= {"svt::verify.read", "svt::fold.read"}
    _waits_match_their_count(recorder)


def test_fold_levels_are_spans_with_their_read_and_verify(recorder):
    n = 34
    assert KzgAs.group_size(n) == 17  # folds in two groups, then the top
    pts = limbs_to_words(_points(2 * n)).view(n, 2, 3, 8)
    timings = {}
    KzgAs.fold_hierarchical(pts, timings)
    assert set(timings) == {"fold_groups_s", "fold_top_s"}
    assert [s for s, outer in recorder.spans if not outer] == ["svt::fold.groups", "svt::fold.top"]
    assert recorder.parents("svt::fold.read") == {"svt::fold.groups", "svt::fold.top"}
    assert recorder.parents("svt::fold.verify") == {"svt::fold.groups", "svt::fold.top"}


def test_msm_spans_nest_under_svt_msm_in_a_real_profile():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        msm_checked(_points(4), scalars_from_int([5, 6, 7, 8]), c=4, device="cpu")
    parent = {}
    for ev in prof.events():
        if ev.name.startswith("svt::"):
            parent.setdefault(ev.name, set()).add(ev.cpu_parent.name if ev.cpu_parent else None)
    steps = ("points", "digits", "slots", "top_slots", "fold", "reduce")
    assert parent["svt::msm"] == {None}
    assert parent["svt::msm.attempt"] == {"svt::msm"}
    assert all(parent[f"svt::msm.{s}"] == {"svt::msm.attempt"} for s in steps)
    assert parent["svt::wait.msm_digits"] == {"svt::msm.attempt"}
    assert parent["svt::wait.msm_overflow"] == {"svt::msm"}


def test_a_crowded_bucket_counts_each_attempt_and_its_waits(recorder):
    _launch.reset_launches()
    n = 40  # one 4-bit bucket holds all 40 points, above the first capacity (29)
    out = msm_checked(_points(n), scalars_from_int([0x1234567] * n), c=4, device="cpu")
    assert _launch.COUNTERS == {"msm_attempts": 2, "host_waits": 4, "packed_uploads": 0}
    assert [s for s, outer in recorder.spans if outer == ("svt::msm",)] == [
        "svt::msm.attempt", "svt::wait.msm_overflow"] * 2
    want = py_ec.scalar_mul(py_ec.G1_GEN, 0x1234567 * n * (n + 1) // 2 % FR.p)
    assert to_affine_int(out) == want
    _launch.LAUNCHES["fold_buckets"] += 1
    _launch.reset_launches()
    assert set(_launch.COUNTERS.values()) == {0} and set(_launch.LAUNCHES.values()) == {0}
