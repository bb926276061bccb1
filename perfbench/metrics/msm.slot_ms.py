"""The slot assignment's device time a commitment: the kernels launched
under the harness's span around `msm.pippenger._slot_indices` (every
window's sort, counts and scatter), in the traced slice B."""

SPAN = "bench::_slot_indices"


def read(run):
    b = run.slice_b
    if b is None or SPAN not in b.span_device_s or not b.calls:
        return None
    return 1e3 * b.span_device_s[SPAN] / b.calls
