"""The yardstick's work counts and peaks, frozen: the least 32-bit
multiply-adds of the operations the kernels run, the algorithm's counts
for a call's shapes (whatever kernel does the work), and the NVIDIA H100
SXM's peaks.

The integer peak is derived, not published: 64 32-bit multiply-adds an SM
a clock (`IMAD`), 132 SMs, 1.98 GHz, at the card's 700 W power limit;
`IMAD.WIDE` issues at half that rate, so no kernel of 64-bit products
reaches it.  The bandwidth is the data sheet's 3.35 TB/s."""

from __future__ import annotations

IMAD_PER_S = 64 * 132 * 1.98e9  # 16.7e12 32-bit multiply-adds/s
HBM_BYTES_PER_S = 3.35e12

MULADDS_PER_FQ_MUL = 136  # 8x32-bit words: 64 a·b + 8 m + 64 m·p
MULADDS_PER_FQ_SQR = 108
MULADDS_PER_SUM_OF_PRODUCTS = 200  # a·b + c·d with one reduction
MULADDS_PER_ADD = 6 * MULADDS_PER_FQ_MUL + 3 * MULADDS_PER_SUM_OF_PRODUCTS  # 1,416
MULADDS_PER_DOUBLE = 960  # the least complete doubling (a = 0)
POSEIDON_MULS = 828  # field muls a permutation: 8 full rounds of 18, 57 partial of 12

C_BITS = 8  # the window of the bucket method the fold's count assumes
SCALAR_BITS = 256


def bound_s(muladds: float = 0.0, n_bytes: float = 0.0) -> float:
    """The least seconds of a call: the larger of its multiply-adds over
    the integer peak and its bytes over the bandwidth."""
    return max(muladds / IMAD_PER_S, n_bytes / HBM_BYTES_PER_S)


def msm_windowed_muladds(n: int) -> int:
    """Multiply-adds of one lane's windowed MSM of n bases, the smaller of
    two schedules: the whole scalar's 64 windows (a table of 14 adds a
    base, per window a tree of n - 1 adds, one add into the accumulator and
    4 doublings: 78 n adds, 256 doublings), and the GLV halves' (the same
    78 n adds over 2 n half-scalars of 32 windows, 128 doublings, and 15
    products by beta a base for the table of phi(P))."""
    dbls = min(256 * MULADDS_PER_DOUBLE, 128 * MULADDS_PER_DOUBLE + 15 * n * MULADDS_PER_FQ_MUL)
    return 78 * n * MULADDS_PER_ADD + dbls


def fold_least_adds(nonzero_digits: int, nonempty_buckets: int) -> int:
    """The bucket fold's least group adds: a bucket of m points takes m - 1."""
    return nonzero_digits - nonempty_buckets


def poseidon_muladds(permutations: int) -> int:
    return permutations * POSEIDON_MULS * MULADDS_PER_FQ_MUL
