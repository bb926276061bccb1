"""The harness's own device code on the card (marked `gpu`; each test
skips inside itself where there is no card): the MSM cell's bases made in
plain torch on the card against python ints, and the profiler slice
reading the card's kernels.

    python -m pytest -q -m gpu perfbench/tests/test_perfbench_card.py
"""

import pytest
import torch

from harness import codec, trace
from harness import traffic as tr
from harness.entries import msm_commit
from reference import py_ec
from reference.fields import FR


@pytest.mark.gpu
def test_bases_on_the_card_are_the_seeded_multiples(card):
    n = 1 << 14
    a, d = tr.msm_base_params(2**31 + 11, n)
    bases = msm_commit.make_bases(n, a, d, card, chunk=1 << 12).cpu()
    for i in (0, 1, 2047, 2048, 5000, n - 1):
        want = py_ec.scalar_mul(py_ec.G1_GEN, (a + (i + 2048) * d) % FR.p)
        assert codec.affine(bases[i].numpy(), 16) == want
    sc = msm_commit.make_scalars(n, 1, tr.msm_scalar_seed(3), card)[0]
    again = msm_commit.make_scalars(n, 1, tr.msm_scalar_seed(3), card)[0]
    assert torch.equal(sc, again) and sc.shape == (n, 16)


@pytest.mark.gpu
def test_the_device_slice_reads_kernels(card):
    x = torch.randn(1 << 20, device=card)
    with trace.profile(False) as prof:
        for _ in range(4):
            x = x * 1.0001
        torch.cuda.synchronize()
    kernels = trace.device_kernels(prof)
    assert len(kernels) >= 4 and all(e > s for _, s, e in kernels)
