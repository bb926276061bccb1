// The port's MSM kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes, see _build.py and msm/cuda_ops.py).  Points are
// (B, 3, 8) 32-bit words: Fq in Montgomery form, homogeneous projective.
//
// Three kernels, each the counterpart of a Pallas kernel of the JAX package:
//
// * svt_g1_add    replaces msm/pallas_ops.py::add (_binop_kernel ->
//                 _rc15_add_2d): the RC15 complete add of two point batches.
// * svt_g1_double replaces msm/pallas_ops.py::double (_unop_kernel ->
//                 _rc15_double_2d): the RC15 complete doubling.
// * svt_fold_buckets replaces msm/pippenger.py::_fold_buckets_pallas: the
//                 XLA gather of the slot-index matrix plus the Pallas bucket
//                 fold (pallas_ops.py::fold_buckets_grid_pk and
//                 ::fold_buckets_grid).  The gather is fused: the kernel reads
//                 point rows by index, so the (buckets, capacity) matrix of
//                 points is never written to device memory (249 MB per window
//                 on the JAX path at 2^20).
//
// What bounds them on an H100 SXM: the integer multiply throughput, 64
// 32-bit multiply-adds per SM per clock, 132 SMs at 1.98 GHz = 16.7e12/s.
// An add is 12 Fq muls = 12 * 136 = 1632 multiply-adds: 97.5 ps of the card.
// Its bytes: two 96-byte points in, one out = 288 B at 3.35 TB/s = 86 ps.
// A double: 8 * 136 = 1088 multiply-adds = 65 ps, against 192 B = 57 ps.
// So the add and double kernels sit just above the ridge, on the multiply
// side, and the fold, which reads one 96-byte point (+ a 4-byte index) per
// add, is multiply-bound three times over.  Integer Montgomery arithmetic
// has no tensor-core path (wgmma takes floating point and int8 tiles), and
// its 64-bit products run at half that rate (fq.cuh), so half of the
// bound is the most this multiply can reach.
//
// What the fold's design does about it.  Its time is the latency of each
// thread's chain of dependent adds unless enough independent chains are
// resident to fill the multiply pipes, so the design is about residency:
// * rows fill the card, not threads within a row.  The MSM folds all its
//   main windows in one launch (7,936 rows at 2^20), one warp per row: each
//   lane sums its strided slots in registers and the warp reduces with five
//   rounds of shuffles -- no shared memory, no block barrier, and other
//   rows' warps on the SM fill the lanes the tree leaves idle.  A launch
//   with few rows (the top window's segments, a lone window) gives a row a
//   team of 64 or 128 threads instead (their warps' sums meet in shared
//   memory), so that it still fills the card; the host picks the largest
//   team whose blocks are all resident at once (cuda_ops._fold_team);
// * blocks of 128 threads bounded to three per SM: 168 registers, no
//   spills, three warps per scheduler.  Four per SM cost 128 registers and
//   60-76 bytes of spills and measured 2-10% slower; two were no faster;
// * each lane reads its index two slots ahead and asks for its next point
//   before it adds the current one, so the gather's latency hides behind
//   the add.
// All main windows of the 2^20 MSM fold in 8.1 ms, 2.6x their bound and
// about 80% of the rate the multiply itself reaches (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py).  What is left on the table: points
// in array-of-structures rows (96-byte stride, six 16-byte loads per lane);
// one thread still carries a whole 256-bit product.  The add and double
// kernels stay as the counterparts of the two Pallas kernels; no main path
// launches them since msm_loops.cu took over the loops that did.

#include <cuda_runtime.h>

#include <cstdint>

#include "g1.cuh"

namespace svt {

constexpr int PT_THREADS = 256;
constexpr int FOLD_BLOCK = 128;
// Resident fold blocks per SM that the register bound allows for; the
// wrapper's choice of team (cuda_ops._fold_team) counts on the same number.
constexpr int FOLD_BLOCKS_PER_SM = 3;

__global__ void __launch_bounds__(PT_THREADS)
    g1_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * PT_THREADS + threadIdx.x;
  if (i >= n) return;
  G1 p, q;
  g1_load(p, a + i * G1_WORDS);
  g1_load(q, b + i * G1_WORDS);
  g1_add(p, p, q);
  g1_store(out + i * G1_WORDS, p);
}

__global__ void __launch_bounds__(PT_THREADS)
    g1_double_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * PT_THREADS + threadIdx.x;
  if (i >= n) return;
  G1 p;
  g1_load(p, a + i * G1_WORDS);
  g1_double(p, p);
  g1_store(out + i * G1_WORDS, p);
}

// Bucket sums of idx (nb, cap): a team of TEAM threads per row, FOLD_BLOCK /
// TEAM rows per block.  Thread t of a team sums slots t, t + TEAM, ... of its
// row into a register accumulator; entries equal to `sentinel` (the index of
// the identity row, n) -- or outside [0, sentinel) -- are the identity and
// are skipped.  The team's partial sums are reduced by shuffles inside each
// warp and, for a team of several warps, once more through shared memory.
// Summation order differs from the plain version's halving fold, so the
// projective outputs differ; the points are equal.
template <int TEAM>
__global__ void __launch_bounds__(FOLD_BLOCK, FOLD_BLOCKS_PER_SM)
    fold_buckets_kernel(const uint32_t* __restrict__ points, const int32_t* __restrict__ idx,
                        long long nb, long long cap, int sentinel, uint32_t* __restrict__ out) {
  static_assert(TEAM % 32 == 0 && FOLD_BLOCK % TEAM == 0, "a team is whole warps of one block");
  const int t = threadIdx.x % TEAM;
  const long long r = (long long)blockIdx.x * (FOLD_BLOCK / TEAM) + threadIdx.x / TEAM;
  // A team past the last row repeats it and stores nothing: every thread of
  // the block reaches the barrier below.
  const int32_t* row = idx + (r < nb ? r : nb - 1) * cap;
  G1 acc, cur;
  g1_identity(acc);
  int k0 = t < cap ? __ldg(row + t) : sentinel;
  int k1 = t + TEAM < cap ? __ldg(row + t + TEAM) : sentinel;
  bool live = (unsigned)k0 < (unsigned)sentinel;
  // Row `sentinel` of points is the identity: an empty slot loads it and
  // skips the add.
  g1_load_nc(cur, points + (long long)(live ? k0 : sentinel) * G1_WORDS);
#pragma unroll 1
  for (long long j = t; j < cap; j += TEAM) {
    const int k2 = j + 2 * TEAM < cap ? __ldg(row + j + 2 * TEAM) : sentinel;
    const bool live1 = (unsigned)k1 < (unsigned)sentinel;
    G1 nxt;
    g1_load_nc(nxt, points + (long long)(live1 ? k1 : sentinel) * G1_WORDS);
    if (live) g1_add(acc, acc, cur);
    cur = nxt;
    live = live1;
    k1 = k2;
  }
#pragma unroll 1
  for (int s = 16; s > 0; s >>= 1) {
    G1 q;
    g1_shfl_xor(q, acc, s);
    g1_add(acc, acc, q);
  }
  if constexpr (TEAM > 32) {
    constexpr int WARPS = TEAM / 32;
    __shared__ uint4 part[(FOLD_BLOCK / 32) * (G1_WORDS / 4)];
    // this team's WARPS slots of the block's array
    uint32_t* words = reinterpret_cast<uint32_t*>(part) + (threadIdx.x / TEAM) * WARPS * G1_WORDS;
    if (t % 32 == 0) g1_store(words + (t / 32) * G1_WORDS, acc);
    __syncthreads();
    if (t >= 32) return;
    // Lanes 0 .. WARPS-1 of warp 0 take one warp's sum each; the lanes
    // above them repeat lane 0's and their results are not used.
    g1_load(acc, words + (t < WARPS ? t : 0) * G1_WORDS);
#pragma unroll 1
    for (int s = WARPS / 2; s > 0; s >>= 1) {
      G1 q;
      g1_shfl_xor(q, acc, s);
      g1_add(acc, acc, q);
    }
  }
  if (t == 0 && r < nb) g1_store(out + r * G1_WORDS, acc);
}

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

extern "C" int svt_g1_add(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::PT_THREADS - 1) / svt::PT_THREADS);
    svt::g1_add_kernel<<<blocks, svt::PT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_g1_double(const void* a, void* out, long long n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::PT_THREADS - 1) / svt::PT_THREADS);
    svt::g1_double_kernel<<<blocks, svt::PT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// team: threads per bucket row, 32, 64 or 128 (the wrapper picks it from nb).
extern "C" int svt_fold_buckets(const void* points, const void* idx, long long nb, long long cap,
                                int sentinel, void* out, int team, void* stream) {
  if (team != 32 && team != 64 && team != svt::FOLD_BLOCK) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const auto st = (cudaStream_t)stream;
    const long long rows_per_block = svt::FOLD_BLOCK / team;
    const unsigned blocks = (unsigned)((nb + rows_per_block - 1) / rows_per_block);
    const auto* pts = (const uint32_t*)points;
    const auto* ix = (const int32_t*)idx;
    auto* o = (uint32_t*)out;
    if (team == 32)
      svt::fold_buckets_kernel<32><<<blocks, svt::FOLD_BLOCK, 0, st>>>(pts, ix, nb, cap, sentinel, o);
    else if (team == 64)
      svt::fold_buckets_kernel<64><<<blocks, svt::FOLD_BLOCK, 0, st>>>(pts, ix, nb, cap, sentinel, o);
    else
      svt::fold_buckets_kernel<svt::FOLD_BLOCK><<<blocks, svt::FOLD_BLOCK, 0, st>>>(
          pts, ix, nb, cap, sentinel, o);
  }
  return (int)cudaGetLastError();
}
