"""The batch add and double of csrc/msm_kernels.cu (`svt_g1_add`,
`svt_g1_double`: persistent blocks fed by TMA bulk copies, one Montgomery
reduction a sum of two products, canonical output), their own C++ run on
the host: a schedule twin.

g++ (C++20) compiles msm_kernels.cu with each `kernel<<<grid, block, ...>>>`
launch turned into a call of the harness's grid runner, a stub of the CUDA
runtime, tests/test_torch_g1_team_schedule.py's portable stand-in for
csrc/fq.cuh (`fe_mul_sum` among its functions; tests/test_torch_mul_schedule.py runs
the real one's carry chains word by word) and a host emulation of
csrc/bulk.cuh:

* an mbarrier is a count of completed phases; a phase completes when its
  one arrival (`bulk_expect`) and the bytes it was armed for have landed;
  a wait on a phase that no issued copy can complete fails the run;
* copies happen either at their issue (the earliest moment the hardware may
  move them: a load into a stage some thread still reads, or a store of a
  tile not yet staged, shows as a wrong value) or at the wait (the latest:
  a read of a stage before its wait shows); every copy checks 16-byte
  alignment and size.

A block's threads are std::threads that take turns, each running from one
`__syncthreads` to the next, in thread order or in reverse, and handing the
turn to the next by its semaphore; blocks run one after another on the same
threads, `gridDim` and the blocks' walk over the tiles are the entry
point's own (the SM count of the stub is a parameter: on 1 SM the double's
5 blocks walk a ragged batch of 16 tiles three or four tiles a block, each
stage of the ring used twice).

Checked at n = 0, 1, 2, a tile - 1, a tile, a tile + 1 and 1,957 (16
tiles, the last ragged), with the identity, P = Q, P = -Q and lazy [0, 2p] words
among the inputs: each output is canonical (every word below p), equals the
plain version's words after `canon`, and equals python ints as an affine
point.  Variants of the template (shared reduction on or off, bulk or
direct loads, 3 to 5 blocks an SM: a ring of two stages or one) at 129 and
1,957, in both copy moments and thread orders.
Skips inside each test where no g++ is found.  Tolerance: exact."""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import test_torch_g1_team_schedule as team
import torch

from snark_verifier_tpu_torch.ec import py_ec, to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FQ_FIELD
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.msm import cuda_ops

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
TILE = 128  # msm_kernels.cu's G1B_THREADS
SIZES = (0, 1, 2, TILE - 1, TILE, TILE + 1, 15 * TILE + 37)

RUNTIME_STUB = r"""
#pragma once
#include <cstdint>
#include <cstdlib>
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
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
extern dim3_ gridDim;
void __syncthreads();
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __shfl_xor_sync(unsigned, unsigned, int) { abort(); }  // the fold's; not run
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
extern int svt_sms, svt_smem_limit;
inline cudaError_t cudaGetLastError() { return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= svt_smem_limit ? 0 : cudaErrorInvalidValue; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = svt_sms; return 0; }
"""

FIELD_STUB = team.FIELD_STUB  # fq.cuh's functions, fe_mul_sum among them

# bulk.cuh on the host.  `svt_copy_early`: copies at their issue, else at
# the wait.  Only thread 0 issues and waits on stores; every thread waits on
# loads.  A fault exits with a code the test reports.
BULK_STUB = r"""
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <vector>
extern bool svt_copy_early;
namespace svt {
inline void bulk_fault(const char* what, int code) {
  fprintf(stderr, "bulk emulation: %s\n", what); exit(code); }
struct BulkCopy { void* dst; const void* src; uint32_t bytes; };
inline void bulk_check(const void* dst, const void* src, uint32_t bytes) {
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16 || !bytes)
    bulk_fault("a copy not in whole aligned 16-byte units", 20); }
inline std::vector<BulkCopy>& bulk_pending() { static std::vector<BulkCopy> v; return v; }
inline void bulk_fence_shared() {}
inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  bulk_check(dst, src, bytes);
  if (svt_copy_early) memcpy(dst, src, bytes);
  else bulk_pending().push_back({dst, src, bytes}); }
inline void bulk_wait_read() {
  for (auto& c : bulk_pending()) memcpy(c.dst, c.src, c.bytes);
  bulk_pending().clear(); }
inline void bulk_wait() { bulk_wait_read(); }
// The phase in progress of each barrier: its arrival, bytes armed and
// landed, and (copying at the wait) the copies not yet made.
struct Phase {
  bool arrived = false;
  uint64_t armed = 0, issued = 0, landed = 0;
  std::vector<BulkCopy> q;
};
inline std::map<uint64_t*, Phase>& bulk_phases() { static std::map<uint64_t*, Phase> m; return m; }
inline void bulk_settle(uint64_t* bar) {
  Phase& ph = bulk_phases()[bar];
  for (auto& c : ph.q) { memcpy(c.dst, c.src, c.bytes); ph.landed += c.bytes; }
  ph.q.clear();
  if (ph.arrived && ph.landed == ph.armed) { ++*bar; ph = Phase(); } }
inline void bulk_barrier_init(uint64_t* bar) { *bar = 0; bulk_phases()[bar] = Phase(); }
inline void bulk_fence_init() {}
inline void bulk_expect(uint64_t* bar, uint32_t bytes) {
  Phase& ph = bulk_phases()[bar];
  if (ph.arrived) bulk_fault("two arrivals in one phase", 21);
  ph.arrived = true; ph.armed += bytes; }
inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  bulk_check(dst, src, bytes);
  Phase& ph = bulk_phases()[bar];
  if (!ph.arrived) bulk_fault("a load into a phase with no arrival", 22);
  ph.q.push_back({dst, src, bytes});
  if ((ph.issued += bytes) > ph.armed) bulk_fault("more bytes than the phase was armed for", 23);
  if (svt_copy_early) bulk_settle(bar); }
inline void bulk_wait_phase(uint64_t* bar, uint32_t parity) {
  bulk_settle(bar);
  if ((*bar & 1u) == parity) bulk_fault("a wait on a phase nothing completes", 24); }
}  // namespace svt
"""

# Reads (op, entry, sum, bulk, blocks, n, sms, forward, early) and the
# inputs; runs the entry point (entry = 1) or the given variant of the
# template.
HARNESS = r"""
#include <cstdio>
#include <memory>
#include <semaphore>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
dim3_ gridDim;
int svt_sms = 1, svt_smem_limit = 232448;
bool svt_copy_early = false;
static bool forward = false;
// A block: its threads take turns in `order`, each running until its next
// __syncthreads or its end, then handing the turn to the next thread in
// order that has not ended (its own semaphore: one thread wakes a turn),
// or to the grid runner once all have.
struct Block {
  std::vector<int> order;
  std::vector<char> done;
  size_t pos = 0;
  std::vector<std::unique_ptr<std::binary_semaphore>> turn;
  std::binary_semaphore finished{0};
};
static Block* cur;
static thread_local int me;
static void pass(Block& b) {
  const size_t n = b.order.size();
  for (size_t s = 1; s <= n; s++) {
    const size_t q = (b.pos + s) % n;
    if (!b.done[b.order[q]]) {
      b.pos = q;
      b.turn[b.order[q]]->release();
      return;
    }
  }
  b.finished.release();
}
void __syncthreads() {
  pass(*cur);
  cur->turn[me]->acquire();
}
// The grid's blocks one after another on one set of threads.
template <class Kernel> void svt_grid(long long blocks, int threads, Kernel kernel) {
  gridDim.x = (unsigned)blocks;
  Block b;
  for (int t = 0; t < threads; t++) {
    b.order.push_back(forward ? t : threads - 1 - t);
    b.turn.emplace_back(new std::binary_semaphore(0));
  }
  cur = &b;
  std::vector<std::thread> th;
  for (int t = 0; t < threads; t++)
    th.emplace_back([&, t] {
      me = t; threadIdx.x = (unsigned)t;
      for (long long blk = 0; blk < blocks; blk++) {
        b.turn[t]->acquire();
        blockIdx.x = (unsigned)blk;
        kernel();
        b.done[t] = 1;
        pass(b);
      } });
  for (long long blk = 0; blk < blocks; blk++) {
    b.done.assign(threads, 0);
    b.pos = 0;
    b.turn[b.order[0]]->release();
    b.finished.acquire();
  }
  for (auto& x : th) x.join(); }
#include "msm_kernels.cpp"
namespace svt { alignas(16) uint4 g1b_smem[g1b_smem_bytes<2, 2>() / 16]; }
template <int IN, int K>
int variant(int sum, int bulk, const void* a, const void* b, void* out, long long n) {
  using namespace svt;
  if (sum) return bulk ? launch_g1_batch<IN, true, true, K>(a, b, out, n, nullptr)
                       : launch_g1_batch<IN, true, false, K>(a, b, out, n, nullptr);
  return bulk ? launch_g1_batch<IN, false, true, K>(a, b, out, n, nullptr)
              : launch_g1_batch<IN, false, false, K>(a, b, out, n, nullptr);
}
template <int IN>
int variant(int sum, int bulk, int blocks, const void* a, const void* b, void* out,
            long long n) {
  if (blocks == 3) return variant<IN, 3>(sum, bulk, a, b, out, n);
  if (blocks == 4) return variant<IN, 4>(sum, bulk, a, b, out, n);
  return variant<IN, 5>(sum, bulk, a, b, out, n);
}
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[9];
  if (fread(h, 8, 9, f) != 9) return 2;
  const long long op = h[0], entry = h[1], sum = h[2], bulk = h[3], blocks = h[4], n = h[5];
  svt_sms = (int)h[6]; forward = h[7] != 0; svt_copy_early = h[8] != 0;
  const int in = op == 0 ? 2 : 1;
  // 16-byte aligned rows, as the wrappers check on the card
  std::vector<uint4> a(n * 6 + 1), b(n * 6 + 1), out(n * 6 + 1);
  if (n && fread(a.data(), 96, n, f) != (size_t)n) return 3;
  if (n && in == 2 && fread(b.data(), 96, n, f) != (size_t)n) return 3;
  int err;
  if (entry)
    err = in == 2 ? svt_g1_add(a.data(), b.data(), out.data(), n, nullptr)
                  : svt_g1_double(a.data(), out.data(), n, nullptr);
  else
    err = in == 2 ? variant<2>(sum, bulk, blocks, a.data(), b.data(), out.data(), n)
                  : variant<1>(sum, bulk, blocks, a.data(), nullptr, out.data(), n);
  if (err) return 10 + err;
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 96, n, o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernels' C++ on the host")
    d = tmp_path_factory.mktemp("g1_batch_schedule")
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "fq.cuh").write_text(FIELD_STUB)
    (d / "bulk.cuh").write_text(BULK_STUB)
    shutil.copy(CSRC / "g1.cuh", d / "g1.cuh")
    src = team._host_source((CSRC / "msm_kernels.cu").read_text())
    assert "<<<" not in src
    (d / "msm_kernels.cpp").write_text(src)
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(op, a, b=None, variant=None, sms=1, forward=False, early=False):
        """op "add" or "double" over (n, 3, 8) words; variant (sum, bulk,
        blocks an SM) or None for the C entry point -> (n, 3, 8) words."""
        n = a.shape[0]
        entry, (sum_, bulk, blocks) = (1, (0, 0, 0)) if variant is None else (0, variant)
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([op == "double", entry, sum_, bulk, blocks, n, sms, forward,
                              early], np.int64).tobytes())
            for x in (a, b) if op == "add" else (a,):
                f.write(np.ascontiguousarray(x.numpy(), dtype=np.int32).tobytes())
        r = subprocess.run([str(d / "harness"), str(inp), str(out)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, (r.returncode, r.stderr)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(n, 3, 8))

    return run


def _inputs(n, seed):
    """(n, 3, 8) words of p and q and their affine points: random points with
    random Z, some of them lazy (a coordinate + p), and in the first rows
    the identity + P, P + identity, P + P, P + (-P), identity + identity."""
    base = py_ec.rand_points(24, seed=seed)
    rng = random.Random(seed)
    ps = [base[rng.randrange(24)] for _ in range(n)]
    qs = [base[rng.randrange(24)] for _ in range(n)]
    P = base[0]
    for i, (x, y) in enumerate([(None, P), (P, None), (P, P), (P, py_ec.neg(P)), (None, None)]):
        if i < n:
            ps[i], qs[i] = x, y
    zp = [rng.randrange(1, FQ.p) for _ in range(n)]
    zq = [rng.randrange(1, FQ.p) for _ in range(n)]
    pw = team._projective(ps, zp) if n else torch.zeros(0, 3, 8, dtype=torch.int32)
    qw = team._projective(qs, zq) if n else torch.zeros(0, 3, 8, dtype=torch.int32)
    if n > 8:
        pw[6::3] = team._projective(ps[6::3], zp[6::3], lazy=True)
        qw[7::3] = team._projective(qs[7::3], zq[7::3], lazy=True)
    return ps, qs, pw, qw


def _canon(w):
    return FQ_FIELD.canon(words_to_limbs(w))


def _check(op, got, ps, qs, pw, qw):
    want = cuda_ops.add_plain(pw, qw) if op == "add" else cuda_ops.double_plain(pw)
    # canonical words: the same projective triple as the plain version's
    assert torch.equal(words_to_limbs(got), _canon(got)), "a word at or above p"
    assert torch.equal(_canon(got), _canon(want))
    oracle = ([py_ec.add(p, q) for p, q in zip(ps, qs)] if op == "add"
              else [py_ec.double(p) for p in ps])
    assert to_affine_int(words_to_limbs(got)) == oracle


@pytest.mark.parametrize("op", ["add", "double"])
@pytest.mark.parametrize("n", SIZES)
def test_entry_point_matches_plain_and_python_ints(harness, op, n):
    ps, qs, pw, qw = _inputs(n, 40 + n)
    got = harness(op, pw, qw)
    if n:
        _check(op, got, ps, qs, pw, qw)
    if n == SIZES[-1]:  # the other copy moment and thread order, and 132 SMs
        assert torch.equal(harness(op, pw, qw, forward=True, early=True), got)
        assert torch.equal(harness(op, pw, qw, sms=132), got)


@pytest.mark.parametrize("op", ["add", "double"])
@pytest.mark.parametrize("variant", [(1, 1, 3), (1, 1, 4), (1, 0, 5), (0, 1, 3), (0, 0, 3)],
                         ids=["sum-bulk-3", "sum-bulk-4", "sum-direct-5", "separate-bulk-3",
                              "separate-direct-3"])
def test_every_variant_matches_plain_and_python_ints(harness, op, variant):
    """The template's variants (sum, bulk, blocks an SM; the library
    instantiates one an operation, the probe csrc/probe/g1_batch_variants.cu
    the rest; the add's bulk ring has one stage at 4 blocks and more, two
    below): each the same canonical words, at a tile + 1 and at 1,957
    points, copies at their issue with threads in order and at the wait in
    reverse."""
    for n in (TILE + 1, SIZES[-1]):
        ps, qs, pw, qw = _inputs(n, 70 + n)
        got = harness(op, pw, qw, variant=variant)
        _check(op, got, ps, qs, pw, qw)
        assert torch.equal(harness(op, pw, qw, variant=variant, forward=True, early=True), got)


def test_emulation_sees_a_read_before_the_wait(harness, tmp_path):
    """The bulk emulation is not vacuous: msm_kernels.cu with its stage wait
    removed gives wrong words (the bulk add at 3 blocks) when copies land at
    the wait."""
    gxx = shutil.which("g++")
    src = (CSRC / "msm_kernels.cu").read_text()
    cut = "      bulk_wait_phase(bar + s, (uint32_t)(j / STAGES) & 1u);\n"
    assert cut in src
    d = tmp_path
    for name, text in (("cuda_runtime.h", RUNTIME_STUB), ("fq.cuh", FIELD_STUB),
                       ("bulk.cuh", BULK_STUB), ("harness.cpp", HARNESS)):
        (d / name).write_text(text)
    shutil.copy(CSRC / "g1.cuh", d / "g1.cuh")
    (d / "msm_kernels.cpp").write_text(team._host_source(src.replace(cut, "")))
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o", str(d / "h"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)
    ps, qs, pw, qw = _inputs(TILE + 1, 5)
    with open(d / "in.bin", "wb") as f:
        f.write(np.array([0, 0, 1, 1, 3, TILE + 1, 1, 0, 0], np.int64).tobytes())
        f.write(pw.numpy().tobytes())
        f.write(qw.numpy().tobytes())
    subprocess.run([str(d / "h"), str(d / "in.bin"), str(d / "out.bin")], check=True, timeout=300)
    got = torch.from_numpy(np.fromfile(d / "out.bin", np.int32).reshape(-1, 3, 8))
    assert not torch.equal(_canon(got), _canon(cuda_ops.add_plain(pw, qw)))
