"""The Poseidon absorbs' share of their roofline in a tree: every
permutation the tree's transcripts run (each leaf's read and every fold
level's chained absorb, counted by the reference) at 828 field
multiplies of 136 multiply-adds, at the integer peak, over the device
time of the absorb kernel, in the traced slice A."""

from harness import work


KERNELS = ("poseidon_kernel",)


def read(run):
    a = run.slice_a
    t = a.device_s(KERNELS) if a else 0.0
    if t <= 0 or "poseidon_perms_per_tree" not in run.counts:
        return None
    muladds = a.calls * work.poseidon_muladds(run.counts["poseidon_perms_per_tree"])
    return 100.0 * work.bound_s(muladds) / t
