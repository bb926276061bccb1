"""svt_ipa_h_coeffs's own C++ (csrc/ipa_kernels.cu), run on the host: a
schedule twin.  The kernel's order of products differs from the plain
version's doubling (`msm/cuda_ops.py::h_coeffs_plain`): tables of 5-bit
chunks of the coefficient's index built by doubling in shared memory, a
tile's table T[lo] = s P_lo from two of them, a plain factor F from the
others, one product a coefficient, its int64 limbs staged in shared
memory and written by a TMA bulk copy a sub-tile.  This test runs that
code under g++ (the launch syntax stripped, a stub of the CUDA runtime,
the portable fq.cuh stand-in of tests/test_torch_fr_tape_schedule.py, and
a bulk.cuh whose copies happen at the wait, the latest moment the
hardware may read their source): each block's threads are std::threads,
and the block runs them one at a time, each from one `__syncthreads` to
the next, in reverse order (a thread that reads a table entry another
writes across a missing barrier reads a stale value: zeros in the first
block) and, for some cases, in thread order (thread 0 issues a copy
before the others have staged a missing barrier's sub-tile).  Blocks run
one after another; `gridDim` and the blocks' walk over the tiles are the
kernel's own.

Compared word for word with python ints (`h_coeffs_int`, the JAX package's
`reversed(xi)` order: ξ_{k-1} scales bit 0) and the plain version, with
distinct ξ (a swapped bit order shows only then), lazy [0, 2r] inputs and
a scalar factor: the kernel's shape (256 threads, 5-bit chunks, tiles of
2^10 in sub-tiles of 256) at k = 0, 1, 2, 3, 5, 7, 9 (one tile of 2^k,
less than a whole one) and 11, and at 12 on three blocks (four tiles: the
last pass of the walk is partial), k = 3, 9 and 12 also in thread order;
and the same template with 2-bit chunks and 32 threads, whose tiles of 16
put k = 7, 11 and 13 into every kind of chunk (a tile index of several
chunks, each nonzero or zero).  Skips inside the test where no g++ is
found.

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

RUNTIME_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct longlong2 { long long x, y; };
inline longlong2 make_longlong2(long long a, long long b) { return {a, b}; }
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
extern dim3_ gridDim;
void __syncthreads();
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
"""

# bulk.cuh on the host: a copy is queued where the kernel issues it and made
# at the wait (only thread 0 issues and waits).
BULK_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
#include <vector>
namespace svt {
struct BulkCopy { void* dst; const void* src; uint32_t bytes; };
inline std::vector<BulkCopy>& bulk_pending() { static std::vector<BulkCopy> v; return v; }
inline void bulk_fence_shared() {}
inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  bulk_pending().push_back({dst, src, bytes}); }
inline void bulk_wait_read() {
  for (auto& c : bulk_pending()) memcpy(c.dst, c.src, c.bytes);
  bulk_pending().clear(); }
inline void bulk_wait() { bulk_wait_read(); }
}  // namespace svt
"""

# Reads (k, shape, most blocks, order, xi, s); runs the grid the entry point
# would launch with at most `most` blocks, each block's threads taking
# turns in reverse (order 0) or thread order (1); writes the (2^k, 16)
# int64 output.
HARNESS = r"""
#include <condition_variable>
#include <cstdio>
#include <mutex>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "ipa_kernels.cpp"
namespace svt { uint4 hc_smem[hc_smem_bytes<HC_THREADS, HC_CHUNK_BITS>() / 16]; }
thread_local dim3_ threadIdx, blockIdx;
dim3_ gridDim;
// A block: its threads take turns in `order`, each running until its next
// __syncthreads or its end; a phase ends when every live thread has had its
// turn, and the next starts from the first live thread again.
struct Block {
  std::mutex m;
  std::condition_variable cv;
  std::vector<int> order;
  std::vector<char> done;
  size_t pos = 0;
};
static thread_local Block* cur;
static thread_local int me;
static void advance(Block& b) {
  do b.pos++; while (b.pos < b.order.size() && b.done[b.order[b.pos]]);
  if (b.pos == b.order.size()) {
    b.pos = 0;
    while (b.pos < b.order.size() && b.done[b.order[b.pos]]) b.pos++;
  }
  b.cv.notify_all();
}
static void wait_turn(Block& b, std::unique_lock<std::mutex>& l) {
  b.cv.wait(l, [&] { return b.pos < b.order.size() && b.order[b.pos] == me; });
}
void __syncthreads() {
  std::unique_lock<std::mutex> l(cur->m);
  advance(*cur);
  wait_turn(*cur, l);
}
static bool forward = false;
template <class Fn> void run_block(unsigned block, int n, Fn fn) {
  Block b;
  for (int t = 0; t < n; t++) b.order.push_back(forward ? t : n - 1 - t);
  b.done.assign(n, 0);
  std::vector<std::thread> th;
  for (int t = 0; t < n; t++)
    th.emplace_back([&, t] {
      cur = &b; me = t; threadIdx.x = (unsigned)t; blockIdx.x = block;
      { std::unique_lock<std::mutex> l(b.m); wait_turn(b, l); }
      fn();
      std::unique_lock<std::mutex> l(b.m);
      b.done[t] = 1;
      advance(b); });
  for (auto& x : th) x.join();
}
template <int THREADS, int CB>
void grid(const uint32_t* xi, const uint32_t* s, int k, long long most, long long* out) {
  const int tb = svt::HcShape<CB>::TB;
  const long long tiles = 1ll << (k < tb ? 0 : k - tb);
  gridDim.x = (unsigned)(tiles < most ? tiles : most);
  for (unsigned b = 0; b < gridDim.x; b++)
    run_block(b, THREADS, [&] { svt::ipa_h_coeffs_kernel<THREADS, CB>(xi, s, k, out); });
}
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[4];
  if (fread(h, 8, 4, f) != 4) return 2;
  const long long k = h[0], small = h[1], most = h[2];
  forward = h[3] != 0;
  std::vector<uint32_t> xi(k ? k * 8 : 8), s(8);
  if (k && fread(xi.data(), 4, k * 8, f) != (size_t)(k * 8)) return 3;
  if (fread(s.data(), 4, 8, f) != 8) return 3;
  std::vector<long long> out((1ll << k) * 16);
  if (small)
    grid<32, 2>(xi.data(), s.data(), (int)k, most, out.data());
  else
    grid<svt::HC_THREADS, svt::HC_CHUNK_BITS>(xi.data(), s.data(), (int)k, most, out.data());
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
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "fq.cuh").write_text(schedule.FIELD_STUB)
    (d / "bulk.cuh").write_text(BULK_STUB)
    src = (CSRC / "ipa_kernels.cu").read_text()
    (d / "ipa_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-pthread", "-I", str(d), "-o", str(d / "h"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(xi_words, s_words, small=False, most=3, forward=False):
        k = xi_words.shape[0]
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([k, int(small), most, int(forward)], np.int64).tobytes())
            f.write(xi_words.contiguous().numpy().tobytes())
            f.write(s_words.contiguous().numpy().tobytes())
        subprocess.run([str(d / "h"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int64).reshape(1 << k, 16))

    return run


def _words(vals):
    """python ints (raw values < 2^256) -> (n, 8) int32 words."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(len(vals), 16)))


def _inputs(k):
    """Distinct ξ (Montgomery words, some lazy: value + r, still <= 2r) and a
    scalar factor s -> (xi, s, xi words, s words)."""
    rng = np.random.default_rng(100 + k)
    xi = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(k)]
    assert len(set(xi)) == k
    s = int.from_bytes(rng.bytes(32), "little") % R
    mont = [x * MONT % R for x in xi]
    mont = [m + R if i % 2 and m + R < 2 * R else m for i, m in enumerate(mont)]
    xw = _words(mont) if k else torch.zeros((0, 8), dtype=torch.int32)
    return xi, s, xw, _words([s * MONT % R])[0]


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 7, 9, 11, 12])
def test_kernel_body_matches_python_ints_and_plain(kernel_body, k):
    xi, s, xw, sw = _inputs(k)
    got = kernel_body(xw, sw)
    assert [limbs_to_int(r.numpy()) for r in got] == h_coeffs_int(xi, s)
    assert torch.equal(got, cuda_ops.h_coeffs_plain(xw, sw))
    if k in (3, 9, 12):
        assert torch.equal(kernel_body(xw, sw, forward=True), got)
    if k in (0, 5, 11):
        one = _words([MONT % R])[0]
        assert [limbs_to_int(r.numpy()) for r in kernel_body(xw, one)] == h_coeffs_int(xi)


@pytest.mark.parametrize("k", [7, 11, 13])
def test_small_chunks_cover_every_chunk(kernel_body, k):
    """2-bit chunks and tiles of 16 coefficients: the tile index spans
    chunks 2 and up (k = 13: five of them), on three blocks."""
    xi, s, xw, sw = _inputs(k)
    got = kernel_body(xw, sw, small=True)
    assert [limbs_to_int(r.numpy()) for r in got] == h_coeffs_int(xi, s)
    assert torch.equal(got, cuda_ops.h_coeffs_plain(xw, sw))
