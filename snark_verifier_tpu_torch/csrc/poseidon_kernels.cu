// The Poseidon permutation and sponge over BN254 Fr for Hopper (sm_90a),
// bound through a plain C interface (ctypes, see _build.py and
// hash/poseidon.py).
//
// svt_poseidon_permute replaces the JAX package's hash/poseidon.py::permute
// (:110), which XLA runs as a 65-step lax.scan: T = 3, 8 full rounds and
// 57 partial rounds of x^5, each round add-constants -> S-box -> 3x3 MDS.
// svt_poseidon_absorb is the sponge's whole squeeze in one launch: the
// k / 2 + 1 chained permutations of a k-element buffer with the RATE-chunk
// adds, the `1` that pads a short chunk and the all-padding permutation
// (PoseidonJax.squeeze :192), state in registers throughout.  Both run the
// same field ops in the same order as their plain versions, so they agree
// bit for bit on lazy words.
//
// Per state and permutation: 8 * (9 + 9) + 57 * (3 + 9) = 828 Fr multiplies
// = 112,608 multiply-adds, against 2 * 96 bytes moved: bound by operations
// (6.9 us for 1,024 states on an H100 SXM).  The verifier permutes a batch of
// about a thousand states some forty times in sequence, so what it waits for
// is not throughput but the latency of one state's chain of dependent
// multiplies.  What the design does about it:
// * a team of lanes per state.  Lane k of a group of three holds s[k].  The
//   three S-boxes of a full round run side by side (x^5 as two fe_sqr and a
//   multiply), and in the MDS step lane i computes row i from the three
//   elements, exchanged by shuffles.  A lane runs 65 * 6 = 390 multiplies
//   per permutation instead of 828.  (Groups of four with one lane idle
//   measured the same at B = 1,024 and 18% slower at 65,536.)
// * ten states per warp (its last two lanes shadow the tenth) and one warp
//   per block, so a batch of 1,024 spreads over 103 SMs instead of 8;
// * lanes of a warp read different round constants, which constant memory
//   would serialise: the round constants are staged into shared memory at
//   block start, and each lane keeps its MDS row in registers;
// * a squeeze is one launch: the sponge's adds, padding and chained
//   permutations run with the state in registers.
// A permutation of 1,024 states takes 0.157 ms (0.73 with one thread per
// state); the floor of this shape is 390 multiplies of a warp alone on its
// scheduler.  At 65,536 states the team's redundant S-boxes (a partial round
// needs one, every lane computes one) cost throughput: 1.38 ms against a
// bound of 0.44.  (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py.)

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int POS_T = 3;
constexpr int POS_ROUNDS = 65;  // R_F + R_P
constexpr int POS_HALF_F = 4;   // R_F / 2 full rounds on each side
constexpr int POS_BLOCK = 32;                  // one warp per block
constexpr int POS_GROUPS = POS_BLOCK / POS_T;  // states per block: a lane per element
constexpr int POS_RC_VEC = POS_ROUNDS * POS_T * FQ_WORDS / 4;  // round constants, in uint4

__device__ uint4 POS_RC[POS_RC_VEC];                   // (65, 3, 8) words
__device__ uint4 POS_MDS[POS_T * POS_T * FQ_WORDS / 4];  // (3, 3, 8) words

__device__ __forceinline__ void pos_load(uint32_t r[FQ_WORDS], const uint4* src) {
  const uint4 lo = src[0], hi = src[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// States (n, 3, 8) in, states out.  ABSORB: before permutation c of the
// k_in / 2 + 1, slot 1 takes input 2c and slot 2 input 2c + 1 of inputs
// (n, k_in, 8); the first slot past the buffer's end takes the Montgomery 1
// and slots after it nothing.  Without ABSORB: one bare permutation.
template <bool ABSORB>
__global__ void __launch_bounds__(POS_BLOCK)
    poseidon_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ inputs,
                    int k_in, uint32_t* __restrict__ out, long long n) {
  __shared__ uint4 rc[POS_RC_VEC];
  for (int i = threadIdx.x; i < POS_RC_VEC; i += POS_BLOCK) rc[i] = POS_RC[i];
  __syncthreads();
  const int lane = threadIdx.x;
  // The two lanes past the last whole group shadow that group's last lane.
  const int g = lane / POS_T < POS_GROUPS ? lane / POS_T : POS_GROUPS - 1;
  const int k = lane - g * POS_T;        // >= POS_T: a shadow of lane 2
  const int kk = k < POS_T ? k : POS_T - 1;
  const int base = g * POS_T;
  const long long st = (long long)blockIdx.x * POS_GROUPS + g;
  const long long si = st < n ? st : n - 1;  // a tail group shadows the last state
  uint32_t s[FQ_WORDS], m0[FQ_WORDS], m1[FQ_WORDS], m2[FQ_WORDS];
  pos_load(s, reinterpret_cast<const uint4*>(in) + (si * POS_T + kk) * 2);
  pos_load(m0, POS_MDS + (kk * POS_T + 0) * 2);
  pos_load(m1, POS_MDS + (kk * POS_T + 1) * 2);
  pos_load(m2, POS_MDS + (kk * POS_T + 2) * 2);
  const int n_perm = ABSORB ? k_in / 2 + 1 : 1;
#pragma unroll 1
  for (int c = 0; c < n_perm; c++) {
    if (ABSORB && kk >= 1) {
      const int e = 2 * c + kk - 1;  // the buffer element of this lane's slot
      uint32_t v[FQ_WORDS];
      if (e < k_in) {
        pos_load(v, reinterpret_cast<const uint4*>(inputs) + (si * k_in + e) * 2);
        fe_add<FR>(s, s, v);
      } else if (e == k_in) {
        fe_add<FR>(s, s, FIELD_ONE[FR]);
      }
    }
#pragma unroll 1
    for (int r = 0; r < POS_ROUNDS; r++) {
      uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS];
      pos_load(t0, rc + (r * POS_T + kk) * 2);
      fe_add<FR>(s, s, t0);
      // x^5 as s (s^2)^2, kept by every lane of a full round and by lane 0
      // of a partial one.
      fe_sqr<FR>(t0, s);
      fe_sqr<FR>(t0, t0);
      fe_mul<FR>(t0, s, t0);
      const bool full = r < POS_HALF_F || r >= POS_ROUNDS - POS_HALF_F;
      if (full || k == 0) fe_copy(s, t0);
#pragma unroll
      for (int w = 0; w < FQ_WORDS; w++) {
        t0[w] = __shfl_sync(0xffffffffu, s[w], base + 0);
        t1[w] = __shfl_sync(0xffffffffu, s[w], base + 1);
        t2[w] = __shfl_sync(0xffffffffu, s[w], base + 2);
      }
      // out_i = ((M[i][0] s_0 + M[i][1] s_1) + M[i][2] s_2), as the plain
      // version sums.
      fe_mul<FR>(s, m0, t0);
      fe_mul<FR>(t1, m1, t1);
      fe_mul<FR>(t2, m2, t2);
      fe_add<FR>(s, s, t1);
      fe_add<FR>(s, s, t2);
    }
  }
  if (k < POS_T && st < n) {
    uint4* dst = reinterpret_cast<uint4*>(out) + (st * POS_T + k) * 2;
    dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
    dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
}

inline unsigned pos_blocks(long long n) {
  return (unsigned)((n + POS_GROUPS - 1) / POS_GROUPS);
}

}  // namespace svt

// C entry points, returning a cudaError_t (0 = done / launched).

// Copies the round constants (65, 3, 8) and the MDS matrix (3, 3, 8), both
// 32-bit words in Montgomery form, into the current device's memory.
// Synchronous; call once per device before the first permutation.
extern "C" int svt_poseidon_load_constants(const void* rc, const void* mds) {
  cudaError_t err = cudaMemcpyToSymbol(svt::POS_RC, rc, sizeof(svt::POS_RC));
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(svt::POS_MDS, mds, sizeof(svt::POS_MDS));
  return (int)err;
}

// n states (n, 3, 8) in, n permuted states out.
extern "C" int svt_poseidon_permute(const void* in, void* out, long long n, void* stream) {
  if (n > 0) {
    svt::poseidon_kernel<false><<<svt::pos_blocks(n), svt::POS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, nullptr, 0, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// The sponge's squeeze: n states (n, 3, 8) absorb their k buffered elements
// (inputs (n, k, 8), k >= 0) through k / 2 + 1 permutations.
extern "C" int svt_poseidon_absorb(const void* state, const void* inputs, int k, void* out,
                                   long long n, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    svt::poseidon_kernel<true><<<svt::pos_blocks(n), svt::POS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state, (const uint32_t*)inputs, k, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
