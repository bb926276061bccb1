"""The verify MSM's share of its roofline: the least multiply-adds of every
lane's windowed MSM of the protocol's terms (`work.msm_windowed_muladds`)
at the integer peak, over the device time of the kernels that compute
it, both a batch, in the traced slice A."""

from harness import work


KERNELS = ("msm_windowed_kernel",)


def read(run):
    a = run.slice_a
    t = a.device_s(KERNELS) if a else 0.0
    if t <= 0 or "msm_terms" not in run.counts:
        return None
    lanes = sum(run.work[i] for i, r in enumerate(run.records) if r.traced == "A")
    return 100.0 * work.bound_s(lanes * work.msm_windowed_muladds(run.counts["msm_terms"])) / t
