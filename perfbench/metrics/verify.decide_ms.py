"""The pairing decide a batch (`decide_s`).
The program's own step timings (each step between two synchronizes),
taken in the traced run's last part; None where it has none."""

KEYS = ('decide_s',)


def read(run):
    if not run.timings:
        return None
    return 1e3 * sum(sum(t.get(k, 0.0) for k in KEYS) for t in run.timings) / len(run.timings)
