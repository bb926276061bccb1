// svt_fr_powers: the powers [1, r, r^2, ..., r^(N-1)] of a batch of Fr
// challenges, for Hopper (sm_90a), bound through a plain C interface
// (ctypes, see _build.py and pcs/kzg/accumulation.py::powers).
//
// It replaces the JAX package's pcs/kzg/accumulation.py::_powers_stack
// (:196), which XLA runs as an associative scan of LimbField.mul over
// [1, r, r, ..., r]: the weights of the KZG accumulation fold, one row per
// fold transcript.  Torch has no 256-bit modular multiply.
//
// Design: a warp a transcript, a warp a block (B = 1 at the root and 32 at
// a fold level's groups, so the warps spread over the SMs).  Lane j starts
// with r (lane 0 with Montgomery one), and an inclusive multiplicative scan
// over the warp -- rounds k = 1, 2, 4, 8, 16, each a __shfl_up_sync of the
// 8 words and one fe_mul on the lanes >= k (a lane below k keeps its value
// unmultiplied) -- leaves r^j on lane j.  Rounds with k >= N change no lane
// that stores, so they are skipped.  For N > 32 the warp walks chunks of 32:
// chunk c's lane j holds r^(32c) r^j, the carry r^(32c) a chain of products
// by r^32 (lane 31's r^31 times r, shuffled to every lane).  Lanes past N
// take part in every shuffle (full mask) and store nothing.  Each lane then
// leaves through from_mont (the product by plain 1) and fe_canon as the
// canonical plain word that svt_msm_windowed reads as its scalar: the
// output (B, N, 8) is laid out as msm_windowed's (B, n, 8) scalars.  A
// canonical word is a function of the value alone, so the scan's order of
// products gives the words of the chain in the plain version
// (accumulation.py::powers_plain: the limb twin's mul, mul by plain 1 and
// canon), and the values of the JAX package's associative scan.
//
// Bound: the least work, N - 1 products (136 multiply-adds) and N from_mont
// reductions (72) a transcript over the card's 16.7e12 multiply-adds per s,
// or the B (N + 1) 32 bytes moved over 3.35 TB/s.  At the fold's shapes
// (B = 32 or 1, N = 32) the card is nearly empty and the depth sets the
// time: ceil(log2 N) + 1 dependent products at least (6 at N = 32, where
// a chain of products in one thread has 31), ~805 clocks each for a lone
// warp, plus the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int POW_THREADS = 32;  // one warp a block, a warp a transcript
constexpr unsigned POW_MASK = 0xffffffffu;

__global__ void __launch_bounds__(POW_THREADS)
    fr_powers_kernel(const uint32_t* __restrict__ r, int n, uint32_t* __restrict__ out,
                     long long B) {
  const long long b = blockIdx.x;
  const int lane = threadIdx.x;
  if (b >= B) return;  // the whole warp: b is the block's
  uint32_t x[FQ_WORDS], v[FQ_WORDS], u[FQ_WORDS], t[FQ_WORDS], step[FQ_WORDS], carry[FQ_WORDS];
  const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  const uint4* src = reinterpret_cast<const uint4*>(r + b * FQ_WORDS);
  const uint4 lo = src[0], hi = src[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
#pragma unroll
  for (int w = 0; w < FQ_WORDS; w++) v[w] = lane == 0 ? FIELD_ONE[FR][w] : x[w];
  // The scan: after the round of k, lane j holds r^min(j, 2k).
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    if (k >= n) break;  // warp-uniform
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) u[w] = __shfl_up_sync(POW_MASK, v[w], k);
    if (lane >= k) {
      fe_mul<FR>(t, u, v);
      fe_copy(v, t);
    }
  }
  if (n > 32) {  // r^32 = r^31 r, on every lane
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) u[w] = __shfl_sync(POW_MASK, v[w], 31);
    fe_mul<FR>(step, u, x);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * (long long)n * FQ_WORDS);
#pragma unroll 1
  for (long long base = 0; base < n; base += 32) {
    if (base == 32) {
      fe_copy(carry, step);
    } else if (base > 32) {
      fe_mul<FR>(t, carry, step);
      fe_copy(carry, t);
    }
    if (base)
      fe_mul<FR>(u, carry, v);  // r^(base + lane)
    else
      fe_copy(u, v);
    const long long i = base + lane;
    if (i < n) {
      fe_mul<FR>(t, u, one);  // from_mont
      fe_canon<FR>(u, t);
      dst[2 * i] = make_uint4(u[0], u[1], u[2], u[3]);
      dst[2 * i + 1] = make_uint4(u[4], u[5], u[6], u[7]);
    }
  }
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  r (B, 8) Fr Montgomery words, out
// (B, n, 8) canonical plain words, n >= 1.
extern "C" int svt_fr_powers(const void* r, int n, void* out, long long B, void* stream) {
  if (n < 1 || B < 0 || B >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  svt::fr_powers_kernel<<<(unsigned)B, svt::POW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)r, n, (uint32_t*)out, B);
  return (int)cudaGetLastError();
}
