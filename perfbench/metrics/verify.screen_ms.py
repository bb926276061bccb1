"""The per-lane validation screen a batch (`screen_s`, the span
`svt::verify.screen`): each lane's `Snark.validate`, memoized, and the
batch with its refused lanes stood in for and masked.  The program records
the step where the screen refused a lane; a call without it costs one
attribute read a lane and counts 0 here.  The program's own step timings
(each step between two synchronizes), taken in the traced run's last part;
None where no call has the step (a program without the screen)."""

KEY = "screen_s"


def read(run):
    got = [t[KEY] for t in run.timings if KEY in t]
    if not got:
        return None
    return 1e3 * sum(got) / len(run.timings)
