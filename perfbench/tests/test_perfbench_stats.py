"""The rate, tail and idle arithmetic on synthetic records."""

import pytest

from harness import stats
from harness.window import Record, window_seconds


def _records(durations, gap=0.0):
    out, t = [], 100.0
    for d in durations:
        out.append(Record(0, t, t + d, None))
        t += d + gap
    return out


def test_rate_is_all_work_over_all_time():
    recs = _records([0.05] * 100)
    assert window_seconds(recs) == pytest.approx(5.0)
    assert stats.rate([1024.0] * 100, window_seconds(recs)) == pytest.approx(1024 * 20)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = _records([0.05] * 100)
    stalled = _records([0.05] * 94 + [0.5] * 6)
    lat = lambda recs: [r.seconds for r in recs]
    r0 = stats.rate([1.0] * 100, window_seconds(steady))
    r1 = stats.rate([1.0] * 100, window_seconds(stalled))
    assert r1 < r0 * 0.7
    assert stats.percentile(lat(steady), 95) == pytest.approx(0.05)
    assert stats.percentile(lat(stalled), 95) == pytest.approx(0.5)
    # a stall outside the 95th percentile's reach still moves the rate
    one = _records([0.05] * 99 + [2.0])
    assert stats.percentile(lat(one), 95) == pytest.approx(0.05)
    assert stats.rate([1.0] * 100, window_seconds(one)) < r0 * 0.75


def test_percentile_is_nearest_rank_over_every_value():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_busy_is_the_union_of_kernel_intervals():
    ivals = [(0.0, 1.0), (0.5, 1.5), (2.0, 2.5), (2.5, 3.0), (4.0, 4.1)]
    assert stats.union_seconds(ivals) == pytest.approx(1.5 + 1.0 + 0.1)
    assert stats.gaps(ivals) == [(1.5, 2.0), (3.0, 4.0)]
    assert stats.idle_pct(2.6, 5.2) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.idle_pct(1.0, 0.0)


def test_slice_device_time_by_kernel_name():
    from harness.trace import Slice

    s = Slice(calls=2, window_s=1.0,
              kernels=[("void msm_windowed_kernel<6>(...)", 0.0, 0.2),
                       ("poseidon_kernel", 0.3, 0.4), ("void msm_windowed_kernel<1>", 0.5, 0.6)])
    assert s.device_s(("msm_windowed_kernel",)) == pytest.approx(0.3)
    assert s.busy_s == pytest.approx(0.4)
    assert s.top_ops(1)[0][0].startswith("void msm_windowed_kernel<6>")

