"""The warm-up: one call of every input the window cycles, before the
window (the program's first plan records, kernel loads and allocations),
timed by the harness."""


def read(run):
    return run.spans.get("setup.warmup_s")
