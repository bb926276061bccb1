"""The frozen work counts reproduce the bounds PERF.md §6 states: the
verify MSM at (1,024, 26) and the bucket fold over all main windows at
2^20, c = 8."""

import pytest

from harness import work


def test_peaks_and_counts():
    assert work.IMAD_PER_S == pytest.approx(16.7e12, rel=2e-3)
    assert work.MULADDS_PER_ADD == 1416
    assert work.MULADDS_PER_DOUBLE == 960
    assert (work.MULADDS_PER_FQ_MUL, work.MULADDS_PER_FQ_SQR,
            work.MULADDS_PER_SUM_OF_PRODUCTS, work.POSEIDON_MULS) == (136, 108, 200, 828)
    # a Poseidon permutation: 8 full rounds (3 x^5 of 3 muls, 9 MDS) and 57 partial (1, 9)
    assert 8 * (3 * 3 + 9) + 57 * (3 + 9) == work.POSEIDON_MULS


def test_msm_windowed_bound_at_the_verify_shape():
    ms = 1e3 * work.bound_s(1024 * work.msm_windowed_muladds(26))
    assert round(ms, 4) == 0.1866


def test_fold_bound_at_2_20_all_main_windows():
    n, c, main_windows = 1 << 20, 8, 31
    # uniform digits: every window's nonzero digits less its 255 nonempty buckets
    adds = main_windows * work.fold_least_adds(n * 255 // 256, 255)
    assert round(1e3 * work.bound_s(adds * work.MULADDS_PER_ADD), 4) == 2.7403
