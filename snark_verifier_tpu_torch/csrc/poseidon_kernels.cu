// The Poseidon permutation over BN254 Fr for Hopper (sm_90a), bound through
// a plain C interface (ctypes, see _build.py and hash/poseidon.py).
//
// svt_poseidon_permute replaces the JAX package's hash/poseidon.py::permute
// (:110), which XLA runs as a 65-step lax.scan: T = 3, 8 full rounds and
// 57 partial rounds of x^5, each round add-constants -> S-box -> 3x3 MDS.
// One thread carries one (3, 8)-word state through all 65 rounds in
// registers, with the same field ops in the same order as the plain twin,
// so the two agree bit for bit on lazy words.  The round constants and the
// MDS matrix (Montgomery form, made by the port's hash/grain.py) sit in
// constant memory: every thread of a warp reads the same word at once,
// which constant memory serves as a broadcast.
//
// Per state: 8 * (9 + 9) + 57 * (3 + 9) = 828 Fr multiplies = 112,608
// multiply-adds, against 2 * 96 bytes moved: bound by operations (6.9 us
// for 1,024 states on an H100 SXM).  The succinct verifier permutes about
// 40 times in sequence per batch, so at batch 1,024 each launch is short and
// the chain of launches is what costs.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int POS_T = 3;
constexpr int POS_ROUNDS = 65;  // R_F + R_P
constexpr int POS_HALF_F = 4;   // R_F / 2 full rounds on each side
constexpr int POS_THREADS = 128;

__constant__ uint32_t POS_RC[POS_ROUNDS][POS_T][FQ_WORDS];
__constant__ uint32_t POS_MDS[POS_T][POS_T][FQ_WORDS];

__device__ __forceinline__ void pos_sbox(uint32_t s[FQ_WORDS]) {
  uint32_t x2[FQ_WORDS], x4[FQ_WORDS];
  fe_mul<FR>(x2, s, s);
  fe_mul<FR>(x4, x2, x2);
  fe_mul<FR>(s, s, x4);
}

__global__ void __launch_bounds__(POS_THREADS)
    poseidon_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * POS_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t s[POS_T][FQ_WORDS];
#pragma unroll
  for (int k = 0; k < POS_T; k++)
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) s[k][w] = in[(i * POS_T + k) * FQ_WORDS + w];
#pragma unroll 1
  for (int r = 0; r < POS_ROUNDS; r++) {
#pragma unroll
    for (int k = 0; k < POS_T; k++) fe_add<FR>(s[k], s[k], POS_RC[r][k]);
    pos_sbox(s[0]);
    if (r < POS_HALF_F || r >= POS_ROUNDS - POS_HALF_F) {
      pos_sbox(s[1]);
      pos_sbox(s[2]);
    }
    // out_i = ((M[i][0] s_0 + M[i][1] s_1) + M[i][2] s_2), as the twin sums.
    uint32_t ns[POS_T][FQ_WORDS];
#pragma unroll
    for (int row = 0; row < POS_T; row++) {
      uint32_t t[FQ_WORDS];
      fe_mul<FR>(ns[row], POS_MDS[row][0], s[0]);
#pragma unroll
      for (int col = 1; col < POS_T; col++) {
        fe_mul<FR>(t, POS_MDS[row][col], s[col]);
        fe_add<FR>(ns[row], ns[row], t);
      }
    }
#pragma unroll
    for (int k = 0; k < POS_T; k++) fe_copy(s[k], ns[k]);
  }
#pragma unroll
  for (int k = 0; k < POS_T; k++)
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) out[(i * POS_T + k) * FQ_WORDS + w] = s[k][w];
}

}  // namespace svt

// C entry points, returning a cudaError_t (0 = done / launched).

// Copies the round constants (65, 3, 8) and the MDS matrix (3, 3, 8), both
// 32-bit words in Montgomery form, into the current device's constant
// memory.  Synchronous; call once per device before the first permutation.
extern "C" int svt_poseidon_load_constants(const void* rc, const void* mds) {
  cudaError_t err = cudaMemcpyToSymbol(svt::POS_RC, rc, sizeof(svt::POS_RC));
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(svt::POS_MDS, mds, sizeof(svt::POS_MDS));
  return (int)err;
}

// n states (n, 3, 8) in, n permuted states out.
extern "C" int svt_poseidon_permute(const void* in, void* out, long long n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::POS_THREADS - 1) / svt::POS_THREADS);
    svt::poseidon_kernel<<<blocks, svt::POS_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
