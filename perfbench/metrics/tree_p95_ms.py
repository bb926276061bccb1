"""The 95th percentile over every tree of the window of the time from the
call to the root's accept bit on the host."""

from harness import stats


def read(run):
    return 1e3 * stats.percentile([r.seconds for r in run.records], 95)
