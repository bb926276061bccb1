// svt_ipa_h_coeffs: the 2^k coefficients of the IPA decider's polynomial
// h(X) = s * prod_i (1 + xi_{k-1-i} X^(2^i)), for Hopper (sm_90a), bound
// through a plain C interface (ctypes, see _build.py and
// msm/cuda_ops.py::h_coeffs).
//
// It replaces the JAX package's pcs/ipa/ipa.py::h_coeffs_dev (:95), which
// XLA runs as k concatenations of LimbField.mul (coeffs ++ coeffs * xi), and
// the from_mont + to-limbs step of decide (:345-346) after it.  Torch has no
// 256-bit modular multiply.
//
// Coefficient j is s times the product of xi_{k-1-b} over the set bits b of
// j (the JAX package's `reversed(xi)` loop: the last challenge scales bit
// 0).  Design: a thread makes 2^g coefficients (g = min(3, k)), j = t + i*T
// for T = 2^(k-g) threads and i < 2^g: the thread's prefix is s times the
// challenges of t's set bits (the low k - g bits of every j it makes,
// popcount(t) products), then the high g bits double it out in registers
// (v[2^c + i] = v[i] * xi_{g-1-c}: 2^g - 1 products).  Each coefficient
// leaves Montgomery form (the product by plain 1) and fe_canon, and is
// written as 16 int64 limbs of 16 bits: the (2^k, 16) canonical scalars
// that msm/pippenger.py::msm reads (`scalars_u16`), so no host or torch
// step touches the 2^k scalars.  Consecutive threads write consecutive
// coefficients.  A canonical word is a function of the value alone, so the
// order of products gives the words of the plain version
// (cuda_ops.py::h_coeffs_plain, the JAX package's doubling order).
//
// Bound at k = 20: the 2^20 outputs of 128 bytes are 134 MB, 0.040 ms at
// 3.35 TB/s; the least operations, one product (136 multiply-adds) and one
// reduction (72) a coefficient from two half-size tables, are 2.2e8
// multiply-adds, 0.013 ms at 16.7e12 per s.  The bytes set the bound.  This
// design runs ~(popcount + 7) / 8 ~ 2 products a coefficient at k = 20.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int HC_THREADS = 128;
constexpr int HC_GROUP_BITS = 3;  // a thread makes up to 2^3 coefficients

__device__ __forceinline__ void hc_load(uint32_t x[FQ_WORDS], const uint32_t* src) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const uint4 lo = __ldg(s4), hi = __ldg(s4 + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// xi (k, 8) Fr Montgomery words, s (8,) the Montgomery factor, g =
// min(HC_GROUP_BITS, k); out (2^k, 16) int64.
__global__ void __launch_bounds__(HC_THREADS)
    ipa_h_coeffs_kernel(const uint32_t* __restrict__ xi, const uint32_t* __restrict__ s, int k,
                        int g, long long* __restrict__ out) {
  const long long T = 1ll << (k - g);
  const long long t = (long long)blockIdx.x * HC_THREADS + threadIdx.x;
  if (t >= T) return;
  uint32_t v[1 << HC_GROUP_BITS][FQ_WORDS], x[FQ_WORDS], u[FQ_WORDS];
  hc_load(v[0], s);
#pragma unroll 1
  for (int b = 0; b < k - g; b++) {  // bit b of j (b < k - g) is bit b of t
    if ((t >> b) & 1) {
      hc_load(x, xi + (k - 1 - b) * FQ_WORDS);
      fe_mul<FR>(v[0], v[0], x);
    }
  }
#pragma unroll
  for (int c = 0; c < HC_GROUP_BITS; c++) {  // bit k - g + c of j: xi_{g-1-c}
    if (c < g) {
      hc_load(x, xi + (g - 1 - c) * FQ_WORDS);
#pragma unroll
      for (int i = 0; i < (1 << c); i++) fe_mul<FR>(v[(1 << c) + i], v[i], x);
    }
  }
  const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < (1 << HC_GROUP_BITS); i++) {
    if (i < (1 << g)) {
      fe_mul<FR>(u, v[i], one);  // from_mont
      fe_canon<FR>(x, u);
      long long* dst = out + (t + (long long)i * T) * (2 * FQ_WORDS);
#pragma unroll
      for (int w = 0; w < FQ_WORDS; w++) {
        dst[2 * w] = x[w] & 0xffffu;
        dst[2 * w + 1] = x[w] >> 16;
      }
    }
  }
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  xi (k, 8) and s (8,) Fr Montgomery
// words, out (2^k, 16) int64 canonical 16-bit limbs, 0 <= k <= 30.
extern "C" int svt_ipa_h_coeffs(const void* xi, int k, const void* s, void* out, void* stream) {
  if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
  const int g = k < svt::HC_GROUP_BITS ? k : svt::HC_GROUP_BITS;
  const long long T = 1ll << (k - g);
  const unsigned blocks = (unsigned)((T + svt::HC_THREADS - 1) / svt::HC_THREADS);
  svt::ipa_h_coeffs_kernel<<<blocks, svt::HC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xi, (const uint32_t*)s, k, g, (long long*)out);
  return (int)cudaGetLastError();
}
