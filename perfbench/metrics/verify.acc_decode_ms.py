"""The old accumulators' limb decode a batch (`acc_decode_s`, the span
`svt::verify.acc_decode`): 12 instance limbs a lane into (lhs, rhs).
The program's own step timings (each step between two synchronizes),
taken in the traced run's last part; None where no call has the step (a
protocol without `accumulator_indices`, or a program without the span)."""

KEY = "acc_decode_s"


def read(run):
    got = [t[KEY] for t in run.timings if KEY in t]
    if not got:
        return None
    return 1e3 * sum(got) / len(run.timings)
