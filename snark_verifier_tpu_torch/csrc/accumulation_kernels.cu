// svt_fr_powers: the powers [1, r, r^2, ..., r^(N-1)] of a batch of Fr
// challenges, for Hopper (sm_90a), bound through a plain C interface
// (ctypes, see _build.py and pcs/kzg/accumulation.py::powers).
//
// It replaces the JAX package's pcs/kzg/accumulation.py::_powers_stack
// (:196), which XLA runs as an associative scan of LimbField.mul over
// [1, r, r, ..., r]: the weights of the KZG accumulation fold, one row per
// fold transcript.  Torch has no 256-bit modular multiply.
//
// Design.  One thread per transcript, 128 threads a block.  A thread keeps
// r and the running power in registers and runs the N - 1 chained fe_mul
// of fq.cuh; each power leaves through from_mont (the product by plain 1)
// and fe_canon, fused here, as the canonical plain word that
// svt_msm_windowed reads as its scalar: the output (B, N, 8) is laid out
// as msm_windowed's (B, n, 8) scalars.  The plain version
// (accumulation.py::powers_plain) runs the same chain through the limb
// twin's mul and canon, so the two agree word for word.
//
// Bound: (N - 1)·B·136 multiply-adds over the card's 16.7e12 per s, or the
// B·(N + 1)·32 bytes moved over 3.35 TB/s.  At the fold's shapes (B = 32
// groups or 1 root, N = 32) the card is nearly empty and the chain sets the
// time: N - 1 dependent multiplies (the from_mont products hang off the
// chain), at least 272 clocks each for a lone warp, plus the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int POW_THREADS = 128;

__global__ void __launch_bounds__(POW_THREADS)
    fr_powers_kernel(const uint32_t* __restrict__ r, int n, uint32_t* __restrict__ out,
                     long long B) {
  const long long b = (long long)blockIdx.x * POW_THREADS + threadIdx.x;
  if (b >= B) return;
  uint32_t x[FQ_WORDS], acc[FQ_WORDS], t[FQ_WORDS], c[FQ_WORDS];
  const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  const uint4* src = reinterpret_cast<const uint4*>(r + b * FQ_WORDS);
  const uint4 lo = src[0], hi = src[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
#pragma unroll
  for (int w = 0; w < FQ_WORDS; w++) acc[w] = FIELD_ONE[FR][w];
  uint4* dst = reinterpret_cast<uint4*>(out + b * (long long)n * FQ_WORDS);
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    fe_mul<FR>(t, acc, one);  // from_mont
    fe_canon<FR>(c, t);
    dst[2 * i] = make_uint4(c[0], c[1], c[2], c[3]);
    dst[2 * i + 1] = make_uint4(c[4], c[5], c[6], c[7]);
    if (i + 1 < n) {
      fe_mul<FR>(t, acc, x);
      fe_copy(acc, t);
    }
  }
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  r (B, 8) Fr Montgomery words, out
// (B, n, 8) canonical plain words, n >= 1.
extern "C" int svt_fr_powers(const void* r, int n, void* out, long long B, void* stream) {
  if (n < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const unsigned blocks = (unsigned)((B + svt::POW_THREADS - 1) / svt::POW_THREADS);
  svt::fr_powers_kernel<<<blocks, svt::POW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)r, n, (uint32_t*)out, B);
  return (int)cudaGetLastError();
}
