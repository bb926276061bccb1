"""svt_ipa_h_coeffs's own C++ (csrc/ipa_kernels.cu), run on the host: a
schedule twin.  The kernel's order of products differs from the plain
version's doubling (`msm/cuda_ops.py::h_coeffs_plain`): a thread's prefix
over the low k - g bits of its coefficients, then a doubling over the high
g bits in registers.  This test runs that code thread by thread under g++
(the launch syntax stripped, the CUDA runtime stub and the portable fq.cuh
stand-in of tests/test_torch_fr_tape_schedule.py) against python ints
(`h_coeffs_int`, the JAX package's `reversed(xi)` order: ξ_{k-1} scales
bit 0) and the plain version, for k = 0, 1, 2, 3, 5, 7, 9 and 11 with
distinct ξ (a swapped bit order shows only then), lazy [0, 2r] inputs and
a scalar factor.  Skips inside the test where no g++ is found.

Tolerance: exact, word for word (canonical 16-bit limbs)."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import test_torch_fr_tape_schedule as schedule
import torch

from snark_verifier_tpu_torch.ff import FR, limbs_to_int, limbs_to_words
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.pcs.ipa import h_coeffs_int

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
R = FR.p
MONT = 1 << 256

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
dim3_ threadIdx, blockIdx;
#include "ipa_kernels.cpp"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long k;
  if (fread(&k, 8, 1, f) != 1) return 2;
  std::vector<uint32_t> xi(k ? k * 8 : 8), s(8);
  if (k && fread(xi.data(), 4, k * 8, f) != (size_t)(k * 8)) return 3;
  if (fread(s.data(), 4, 8, f) != 8) return 3;
  const int g = k < svt::HC_GROUP_BITS ? (int)k : svt::HC_GROUP_BITS;
  const long long T = 1ll << (k - g);
  std::vector<long long> out((1ll << k) * 16);
  for (long long t = 0; t < T; t++) {
    blockIdx.x = (unsigned)(t / svt::HC_THREADS); threadIdx.x = (unsigned)(t % svt::HC_THREADS);
    svt::ipa_h_coeffs_kernel(xi.data(), s.data(), (int)k, g, out.data());
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 8, out.size(), o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def kernel_body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    d = tmp_path_factory.mktemp("h_coeffs_schedule")
    (d / "cuda_runtime.h").write_text(schedule.RUNTIME_STUB)
    (d / "fq.cuh").write_text(schedule.FIELD_STUB)
    src = (CSRC / "ipa_kernels.cu").read_text()
    (d / "ipa_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(d), "-o", str(d / "h"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(xi_words, s_words):
        k = xi_words.shape[0]
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([k], np.int64).tobytes())
            f.write(xi_words.contiguous().numpy().tobytes())
            f.write(s_words.contiguous().numpy().tobytes())
        subprocess.run([str(d / "h"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int64).reshape(1 << k, 16))

    return run


def _words(vals):
    """python ints (raw values < 2^256) -> (n, 8) int32 words."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(len(vals), 16)))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 7, 9, 11])
def test_kernel_body_matches_python_ints_and_plain(kernel_body, k):
    rng = np.random.default_rng(100 + k)
    xi = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(k)]
    assert len(set(xi)) == k
    s = int.from_bytes(rng.bytes(32), "little") % R
    # Montgomery words, some lazy (value + r, still <= 2r)
    mont = [x * MONT % R for x in xi]
    mont = [m + R if i % 2 and m + R < 2 * R else m for i, m in enumerate(mont)]
    xw = _words(mont) if k else torch.zeros((0, 8), dtype=torch.int32)
    sw = _words([s * MONT % R])[0]
    got = kernel_body(xw, sw)
    assert [limbs_to_int(r.numpy()) for r in got] == h_coeffs_int(xi, s)
    assert torch.equal(got, cuda_ops.h_coeffs_plain(xw, sw))
    one = _words([MONT % R])[0]
    assert [limbs_to_int(r.numpy()) for r in kernel_body(xw, one)] == h_coeffs_int(xi)
