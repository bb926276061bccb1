"""The program's spans read from a host slice (`harness/program_spans.py`):
the idle gaps given to the innermost program span open at each gap's
middle, on synthetic intervals; the readers over a synthetic slice, and
None where the program has no span (the parent of the change that added
them); `tools/trace_spans.py`'s readings, the same in every kind of
slice; a profile of the port's own `_step` spans read back with their
nesting; and a CPU slice of a 4-point MSM, read for its spans and
counters."""

import importlib.util
import os

import pytest
import torch

from harness import program_spans as ps
from harness.program_spans import Span, SpanSlice

HERE = os.path.dirname(os.path.abspath(__file__))
TOOL = os.path.join(os.path.dirname(HERE), "tools", "trace_spans.py")


def _tool():
    spec = importlib.util.spec_from_file_location("trace_spans", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

OUTER = Span("svt::verify", 0.0, 10.0)
PLAN = Span("svt::verify.plan", 0.0, 4.0, ("svt::verify",))
STACK = Span("svt::verify.stack", 1.0, 3.0, ("svt::verify.plan", "svt::verify"))
READ = Span("svt::verify.read", 5.0, 9.0, ("svt::verify",))
KERNELS = [(0.5, 1.5), (2.0, 2.5), (3.0, 3.5), (4.5, 5.5), (6.0, 7.0), (7.5, 8.0), (11.0, 12.0),
           (12.5, 13.0)]


def test_each_gap_goes_whole_to_the_innermost_span_at_its_middle():
    got = ps.attribute_idle(KERNELS, [OUTER, PLAN, STACK, READ])
    # gaps: (1.5, 2) mid 1.75 in stack; (2.5, 3) stack; (3.5, 4.5) mid 4 past the
    # plan's end: the outer span; (5.5, 6) read; (7, 7.5) read; (8, 11) mid 9.5:
    # the outer span; (12, 12.5) no span open
    assert got == {STACK: 1.0, OUTER: 1.0 + 3.0, READ: 1.0, None: 0.5}


def test_gaps_split_across_nested_spans_and_ties_go_to_the_shorter():
    a = Span("svt::tree", 0.0, 100.0)
    b = Span("svt::fold.top", 10.0, 90.0, ("svt::tree",))
    c = Span("svt::fold.read", 20.0, 40.0, ("svt::fold.top", "svt::tree"))
    d = Span("svt::wait.sponge_init", 20.0, 30.0, ("svt::fold.read", "svt::fold.top", "svt::tree"))
    kernels = [(0, 4), (6, 12), (14, 22), (28, 32), (38, 60), (70, 96), (98, 100)]
    got = ps.attribute_idle(kernels, [a, b, c, d])
    assert got == {a: 2 + 2, b: 2 + 10, d: 6, c: 6}


def test_a_gap_with_no_span_open_is_unattributed():
    assert ps.attribute_idle([(0, 1), (2, 3)], []) == {None: 1}
    assert ps.attribute_idle([(0, 1), (2, 3)], [Span("svt::msm", 5, 6)]) == {None: 1}
    assert ps.attribute_idle([(0, 3)], [OUTER]) == {}


def _slice(**kw):
    base = dict(calls=2, window_s=1.0, kernels=[("k", s, e) for s, e in KERNELS],
                spans=[OUTER, PLAN, STACK, READ])
    return SpanSlice(**{**base, **kw})


def test_the_readers_over_a_synthetic_slice():
    sl = _slice(launches={"msm_windowed": 2, "fr_tape": 2, "poseidon_absorb": 18},
                counters={"msm_attempts": 0, "host_waits": 12})
    plan = ("svt::verify.plan",)
    assert ps.idle_ms(sl, plan) == pytest.approx(1e3 * 1.0 / 2)  # stack, under the plan
    assert ps.idle_ms(sl, ("svt::verify.read", "svt::verify.msm")) == pytest.approx(1e3 * 1.0 / 2)
    assert ps.idle_ms(sl, ("svt::verify",)) == pytest.approx(1e3 * 6.0 / 2)
    assert ps.idle_ms(sl, ("svt::fold.top",)) is None
    assert ps.unattributed_pct(sl) == pytest.approx(100 * 0.5 / 6.5)
    assert ps.per_call(sl, sl.launches) == 11
    assert ps.per_call(sl, sl.counters, "host_waits") == 6
    assert ps.per_call(sl, sl.counters, "msm_attempts") == 0
    assert ps.per_call(sl, sl.counters, "fold_levels") is None


def test_device_ms_sums_the_kernels_under_the_named_spans():
    spans = [Span("svt::msm", 0, 10), Span("svt::msm.points", 0, 1, ("svt::msm",), 0.002),
             Span("svt::msm.digits", 1, 2, ("svt::msm",), 0.004),
             Span("svt::msm.slots", 2, 5, ("svt::msm",), 0.5)]
    sl = _slice(spans=spans)
    assert ps.device_ms(sl, ("svt::msm.points", "svt::msm.digits")) == pytest.approx(3.0)
    assert ps.device_ms(sl, ("svt::msm.slots",)) == pytest.approx(250.0)
    assert ps.device_ms(sl, ("svt::verify.msm",)) is None


def test_a_program_without_spans_or_counters_reads_none():
    sl = _slice(spans=[], launches={"msm_windowed": 2})
    assert ps.idle_ms(sl, ("svt::verify.plan",)) is None
    assert ps.unattributed_pct(sl) is None
    assert ps.device_ms(sl, ("svt::msm.points",)) is None
    assert ps.per_call(sl, sl.counters, "msm_attempts") is None
    assert ps.per_call(sl, sl.launches) == 1


@pytest.mark.parametrize("kind", ["verify", "msm", "parent"])
def test_the_tool_reads_every_reading_in_every_kind_of_slice(kind):
    """No reading is chosen by cell: each is None where the slice holds
    none of its spans or counters."""
    if kind == "verify":
        sl = _slice(launches={"msm_windowed": 2}, counters={"msm_attempts": 0, "host_waits": 4})
    elif kind == "msm":
        sl = _slice(spans=[Span("svt::msm", 0.0, 13.0),
                           Span("svt::msm.points", 0.0, 1.0, ("svt::msm",), 0.002)],
                    counters={"msm_attempts": 2, "host_waits": 4})
    else:
        sl = _slice(spans=[], launches={"msm_windowed": 2})
    got = _tool().readings(sl)
    assert set(got) == {"verify.prep_idle_ms", "verify.phase_idle_ms", "tree.fold_idle_ms",
                        "idle_unattributed_pct", "launches", "msm.prep_ms", "msm.attempts",
                        "host_waits"}
    none = {k for k, v in got.items() if v is None}
    if kind == "verify":
        assert none == {"tree.fold_idle_ms", "msm.prep_ms"}
        assert got["verify.prep_idle_ms"] == pytest.approx(500.0) and got["host_waits"] == 2
    elif kind == "msm":
        assert none == {"verify.prep_idle_ms", "verify.phase_idle_ms", "tree.fold_idle_ms"}
        assert got["msm.prep_ms"] == pytest.approx(1.0) and got["msm.attempts"] == 1
        assert got["idle_unattributed_pct"] == pytest.approx(0.0)
    else:
        assert none == set(got) - {"launches"} and got["launches"] == 1


def test_the_ports_spans_read_back_from_a_profile():
    from snark_verifier_tpu_torch.utils import timing

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        timing._step("tree", lambda: timing._step(
            "fold.top", lambda: timing._step("fold.read", lambda: torch.ones(8).sum())))
    spans = {s.name: s for s in ps.program_spans(prof)}
    assert set(spans) == {"svt::tree", "svt::fold.top", "svt::fold.read"}
    assert spans["svt::fold.read"].ancestors == ("svt::fold.top", "svt::tree")
    assert spans["svt::tree"].ancestors == ()
    top, read = spans["svt::fold.top"], spans["svt::fold.read"]
    assert top.start <= read.start <= read.end <= top.end and read.device_s == 0


class _TinyMsm:
    """An entry of four points on the CPU, with the MSM cell's harness
    spans."""

    spans = ("snark_verifier_tpu_torch.msm.pippenger:extract_digits",
             "snark_verifier_tpu_torch.msm.pippenger:_slot_indices")
    n_inputs = 1

    def __init__(self):
        from snark_verifier_tpu_torch.ec import from_affine_int, py_ec
        from snark_verifier_tpu_torch.msm.pippenger import scalars_from_int

        self.points = from_affine_int([py_ec.scalar_mul(py_ec.G1_GEN, i + 1) for i in range(4)])
        self.scalars = scalars_from_int([5, 6, 7, 8])

    def call(self, k):
        from snark_verifier_tpu_torch.msm.pippenger import msm_checked

        return msm_checked(self.points, self.scalars, c=4, device="cpu")


def test_a_cpu_slice_of_a_small_msm_reads_its_spans_and_counters():
    sl = ps.span_slice(_TinyMsm(), 0.0, min_calls=1)
    names = {s.name for s in sl.spans}
    assert sl.calls == 1 and {s.name for s in sl.spans if not s.ancestors} == {"svt::msm"}
    assert {"svt::msm.points", "svt::msm.digits", "svt::wait.msm_overflow"} <= names
    assert sl.counters == {"msm_attempts": 1, "host_waits": 2}
    assert sl.launches and set(sl.launches.values()) == {0}  # no kernel on the CPU
    assert sl.kernels == [] and sl.idle == {} and sl.idle_by_host == {}
