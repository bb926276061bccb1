"""Proofs verified a second: the lanes of every batch completed in the
window over the window's seconds."""

from harness import stats


def read(run):
    return stats.rate(run.work, run.window_s)
