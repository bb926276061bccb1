"""The share of the traced slice in which no operation ran on the device:
100 · (1 − busy / window), busy the union of the kernels' intervals
(torch.profiler, the device alone)."""

from harness import stats


def read(run):
    a = run.slice_a
    if a is None or not a.kernels:
        return None
    return stats.idle_pct(a.busy_s, a.window_s)
