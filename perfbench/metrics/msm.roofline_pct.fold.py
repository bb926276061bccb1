"""The bucket fold's share of its roofline: its least group adds for these
scalars at c = 8 (in every window, nonzero digits less nonempty
buckets) at 1,416 multiply-adds, at the integer peak, over the fold
kernels' device time, in the traced slice A."""

from harness import work


KERNELS = ("fold_buckets_kernel", "fold_segments_kernel")


def read(run):
    a = run.slice_a
    t = a.device_s(KERNELS) if a else 0.0
    adds = run.counts.get("fold_least_adds")
    if t <= 0 or not adds:
        return None
    total = sum(adds[k] for k in a.ks)
    return 100.0 * work.bound_s(total * work.MULADDS_PER_ADD) / t
