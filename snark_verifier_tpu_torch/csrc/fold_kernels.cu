// Dense bucket folds and the add-chain probe for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes, see _build.py and
// msm/cuda_ops.py).  Points are 32-bit words in the kernels' layout
// ((..., 3, 8): Fq in Montgomery form, homogeneous projective).
//
// * svt_fold_segments replaces the three Pallas kernels that fold a DENSE
//   (NB, w, 105) RNS bucket matrix of points (msm/pallas_ops.py):
//   _pallas_fold_level (K adjacent slots per output, :246),
//   _pallas_fold_halving (`layers` halving layers across the width, :326)
//   and _pallas_fold_grid (the same halving inside each wb-wide chunk,
//   3-D blocks, :589).  All three are one function,
//       out[b, j] = sum_{k < count} mat[b, (j / G) * CW + (j % G) + k * S],
//   with (G, CW, S, count) = (1, K, 1, K) for a level, (g, w, g, 2^layers)
//   for halving (g = w >> layers) and (g', wb, g', 2^layers) for the grid
//   (g' = wb >> layers).  Each output slot sums exactly the slot subset of
//   its Pallas kernel; the adds inside a slot run in another order (a
//   chain instead of a tree), so outputs agree in affine form.
// * svt_g1_add_chain and svt_fq_mul_chain replace the probe
//   benchmarks/micro_packed_dissect.py (:48): a chain of CH dependent RC15
//   adds a <- a + b (or Fq multiplies a <- a*b, or squares a <- a^2 when no
//   b is given) on register-resident data.
//   The TPU probe stubbed parts of its RNS multiply; these are exact, and
//   their time is the pure arithmetic rate of one thread's add or multiply
//   with no memory traffic.
//
// Bounds on an H100 SXM (16.7e12 32-bit multiply-adds/s, 3.35 TB/s): a fold
// add is 1632 multiply-adds against one 96-byte point read, so the fold is
// multiply-bound (a full fold of (256, 4624) points: 0.116 ms of multiplies
// against 0.034 ms of reads).  The chains read and write 2 * 96 bytes per
// lane once and do CH * 1632 (or CH * 136) multiply-adds: bound by
// operations at any CH > 1.
//
// What bounds them: the multiply of fq.cuh (carry-flag rows; 58 G muls/s on a
// full card), which is what the multiply chain measures, and for the folds
// the latency of each thread's chain of dependent adds.  What this simple
// design still leaves on the table: one thread per output slot (a level of
// the K = 8 fold launches NB * w / 8 threads, each with a dependent chain of
// 7 adds; the last levels of a fold have too few slots to fill 132 SMs);
// point rows of 96 bytes strided by S slots, so neighbouring threads read
// neighbouring rows only when G > 1.

#include <cuda_runtime.h>

#include <cstdint>

#include "g1.cuh"

namespace svt {

constexpr int SEG_THREADS = 128;
constexpr int CHAIN_THREADS = 128;

__global__ void __launch_bounds__(SEG_THREADS)
    fold_segments_kernel(const uint32_t* __restrict__ mat, long long w, long long wout,
                         long long n_out, long long G, long long CW, long long S, int count,
                         uint32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
  if (t >= n_out) return;
  const long long b = t / wout, j = t % wout;
  const uint32_t* row = mat + b * w * G1_WORDS;
  const long long first = (j / G) * CW + (j % G);
  G1 acc;
  g1_load(acc, row + first * G1_WORDS);
#pragma unroll 1
  for (int k = 1; k < count; k++) {
    G1 p;
    g1_load(p, row + (first + k * S) * G1_WORDS);
    g1_add(acc, acc, p);
  }
  g1_store(out + t * G1_WORDS, acc);
}

__global__ void __launch_bounds__(CHAIN_THREADS)
    g1_add_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, long long n, int ch) {
  const long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= n) return;
  G1 p, q;
  g1_load(p, a + i * G1_WORDS);
  g1_load(q, b + i * G1_WORDS);
#pragma unroll 1
  for (int k = 0; k < ch; k++) g1_add(p, p, q);
  g1_store(out + i * G1_WORDS, p);
}

// SQUARE: ch steps of x <- x^2 through fe_sqr (b is not read); else ch steps
// of x <- x*b through fe_mul.
template <bool SQUARE>
__global__ void __launch_bounds__(CHAIN_THREADS)
    fq_mul_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, long long n, int ch) {
  const long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], y[FQ_WORDS];
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    x[k] = a[i * FQ_WORDS + k];
    y[k] = SQUARE ? 0u : b[i * FQ_WORDS + k];
  }
#pragma unroll 1
  for (int k = 0; k < ch; k++) {
    if constexpr (SQUARE) {
      fe_sqr<FQ>(x, x);
    } else {
      fq_mul(x, x, y);
    }
  }
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) out[i * FQ_WORDS + k] = x[k];
}

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).  The wrappers check that
// every slot index a launch reads lies inside the matrix.

extern "C" int svt_fold_segments(const void* mat, long long nb, long long w, long long wout,
                                 long long G, long long CW, long long S, int count, void* out,
                                 void* stream) {
  const long long n_out = nb * wout;
  if (n_out > 0) {
    const unsigned blocks = (unsigned)((n_out + svt::SEG_THREADS - 1) / svt::SEG_THREADS);
    svt::fold_segments_kernel<<<blocks, svt::SEG_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)mat, w, wout, n_out, G, CW, S, count, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_g1_add_chain(const void* a, const void* b, void* out, long long n, int ch,
                                void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::CHAIN_THREADS - 1) / svt::CHAIN_THREADS);
    svt::g1_add_chain_kernel<<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, ch);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_fq_mul_chain(const void* a, const void* b, void* out, long long n, int ch,
                                void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::CHAIN_THREADS - 1) / svt::CHAIN_THREADS);
    if (b == nullptr)  // the squaring chain
      svt::fq_mul_chain_kernel<true><<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, nullptr, (uint32_t*)out, n, ch);
    else
      svt::fq_mul_chain_kernel<false><<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, ch);
  }
  return (int)cudaGetLastError();
}
