"""The bucket fold's device time a commitment: the fold kernels (every main
window's fused gather and fold, the top window's split folds), in the
traced slice A."""

KERNELS = ("fold_buckets_kernel", "fold_segments_kernel")


def read(run):
    a = run.slice_a
    t = a.device_s(KERNELS) if a else 0.0
    if t <= 0:
        return None
    return 1e3 * t / a.calls
