// The two host loops that drove the point kernels one group operation per
// launch, each moved onto the card as one kernel whose accumulators stay in
// registers from the first window to the last (Hopper, sm_90a; plain C
// interface, ctypes: _build.py, msm/cuda_ops.py, msm/pippenger.py):
//
// * svt_msm_windowed replaces the loop of msm/cuda_ops.py::msm_windowed_plain
//   (its tree_sum included): the verify path's MSM, the JAX package's
//   ec/curve.py::CurveOps.msm_windowed (:194) and ::tree_sum (:245).
//   acc_b = sum_w 2^(4w) sum_i d[b,i,w] P[b,i] over 64 windows of 4 bits.
// * svt_bucket_reduce replaces msm/pippenger.py::bucket_reduce_plain: the
//   2^20 MSM's weighted bucket sums and window combine, the JAX package's
//   msm/pippenger.py::_weighted_bucket_sum (:276) and ::_horner (:284).
//   sum_w 2^(8w) sum_b b B[w,b] over (32, 256) bucket sums.
//
// What bounds them.  Not bytes (a few MB), and not the card's multiply rate
// as the reference counts the work: a verify batch of 1,024 proofs is 3.6 M
// multiply-adds a proof, 0.22 ms of the whole card.  The bucket reduction's
// top window is 248 doublings of one point in a row, a chain no other lane
// can share.  So the designs keep every chain in one warp's registers and
// give the card as many independent chains as the work has:
//
// * msm_windowed: one warp per proof.  Lane i owns base i (then i + 32,
//   ... in further groups when n > 32) and runs its own ladder over all 64
//   windows, MSB first: 4 doublings of its accumulator and the add of its
//   table entry T[d] = d P (built once, 16 points of local memory; T[0] is
//   the identity, which the complete formulas add with no branch).  The
//   warp's 32 sums meet in a shuffle tree at the end.  Every lane doubles
//   on its own -- 26x the doublings of the reference's one accumulator at
//   n = 26 -- but a warp issues a doubling for all its lanes at once, and
//   the chain per window is 4 doublings and 1 add instead of 4 doublings,
//   a 5-level tree and 1 add.  At 1,024 proofs: 2.03 ms, two warps per
//   scheduler at ~80% of the rate they can issue the wide multiply-adds
//   (the reference's shared doublings, a tree per window: 4.84 ms; teams of
//   16 lanes with two bases a lane, half the work in half the warps:
//   2.02 ms, but 1.72 against 1.31 ms for one proof).
// * bucket_reduce: one warp per window.  Lane l owns buckets 8l .. 8l+7 and
//   forms T_l = sum_k B_{8l+k} and U_l = sum_k k B_{8l+k} by running sums;
//   the window's sum is sum_l U_l + 8 sum_l l T_l, and sum_l l T_l =
//   sum_{l>=1} S_l with S_l = sum_{m>=l} T_m, a shuffle suffix scan.  Lane l
//   adds 8 S_l (lane 0: nothing) to U_l, a shuffle tree sums the lanes, and
//   the warp scales its window's sum by 2^(8w) with 8w doublings.  The last
//   warp to finish (an atomic ticket) sums the 32 scaled window sums with
//   one more tree.  Its time, ~1 ms, is the top window's chain: 2,356
//   dependent multiplies at ~830 clocks each for a warp alone (the
//   reference's Horner loop runs the same 248 doublings and 31 adds more).
//
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the runs.)
//
// Results equal the plain versions as points; the order of the sums
// differs, so projective words may not.  Every value stays in the lazy
// [0, 2p] contract of fq.cuh.

#include <cuda_runtime.h>

#include <cstdint>

#include "g1.cuh"

namespace svt {

constexpr int MSMW_BITS = 4;                    // window width (c = 4)
constexpr int MSMW_WINDOWS = 256 / MSMW_BITS;   // 64 windows of a canonical Fr scalar
constexpr int MSMW_TABLE = 1 << MSMW_BITS;      // T[0] .. T[15]

constexpr int RED_C = 8;                          // window width of the MSM (c = 8)
constexpr int RED_WINDOWS = (256 + RED_C - 1) / RED_C;  // 32
constexpr int RED_BUCKETS = 1 << RED_C;           // 256
constexpr int RED_PER_LANE = RED_BUCKETS / 32;    // 8 buckets per lane
constexpr int RED_LANE_SHIFT = 3;                 // log2(RED_PER_LANE)

// Digit w of a canonical scalar (8 words, least significant first): nibble
// w % 8 of word w / 8, the order of ff/word_field.py::digits4.
__device__ __forceinline__ int msmw_digit(const uint32_t* __restrict__ s, int w) {
  return (int)((__ldg(s + (w >> 3)) >> (4 * (w & 7))) & 15u);
}

__global__ void __launch_bounds__(32)
    msm_windowed_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc, int n,
                        uint32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const uint32_t* P = pts + b * n * G1_WORDS;
  const uint32_t* S = sc + b * n * FQ_WORDS;
  G1 sum;
  g1_identity(sum);
#pragma unroll 1
  for (int i = lane; i - lane < n; i += 32) {  // a group of 32 bases, one a lane
    const bool live = i < n;  // a lane past n holds the identity's table
    const uint32_t* s = S + (long long)(live ? i : 0) * FQ_WORDS;
    G1 tab[MSMW_TABLE];
    g1_identity(tab[0]);
    if (live)
      g1_load_nc(tab[1], P + (long long)i * G1_WORDS);
    else
      g1_identity(tab[1]);
#pragma unroll 1
    for (int d = 2; d < MSMW_TABLE; d++) g1_add(tab[d], tab[d - 1], tab[1]);
    G1 acc = tab[live ? msmw_digit(s, MSMW_WINDOWS - 1) : 0];
#pragma unroll 1
    for (int w = MSMW_WINDOWS - 2; w >= 0; w--) {
#pragma unroll 1
      for (int j = 0; j < MSMW_BITS; j++) g1_double(acc, acc);
      const G1 sel = tab[live ? msmw_digit(s, w) : 0];
      g1_add(acc, acc, sel);
    }
    g1_add(sum, sum, acc);
  }
#pragma unroll 1
  for (int m = 16; m > 0; m >>= 1) {
    G1 q;
    g1_shfl_xor(q, sum, m);
    g1_add(sum, sum, q);
  }
  if (lane == 0) g1_store(out + b * G1_WORDS, sum);
}

// One point through L2 only: the window sums other blocks wrote.
__device__ __forceinline__ void g1_load_cg(G1& p, const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t* d[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    const uint4 v = __ldcg(s + k);
    uint32_t* c = d[k / 2] + 4 * (k % 2);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
}

__global__ void __launch_bounds__(32)
    bucket_reduce_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ part,
                         unsigned* __restrict__ ticket, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const int w = blockIdx.x;
  const uint32_t* blk = buckets + ((long long)w * RED_BUCKETS + lane * RED_PER_LANE) * G1_WORDS;
  // Running sums over the lane's block, top bucket first: after bucket k,
  // run = sum_{j>=k} B_j and u = sum_{j>=k} (j - k + 1) B_j; after k = 1,
  // u = sum_k k B_k, and run + B_0 = T_l.
  G1 run, u, bk;
  g1_load_nc(run, blk + (RED_PER_LANE - 1) * G1_WORDS);
  u = run;
#pragma unroll 1
  for (int k = RED_PER_LANE - 2; k >= 1; k--) {
    g1_load_nc(bk, blk + k * G1_WORDS);
    g1_add(run, run, bk);
    g1_add(u, u, run);
  }
  g1_load_nc(bk, blk);
  g1_add(run, run, bk);
  // Suffix scan over the lanes: run becomes S_l = sum_{m>=l} T_m.
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    G1 q;
    g1_shfl_down(q, run, d);
    if (lane + d < 32) g1_add(run, run, q);
  }
  // Lane weights: sum_l (8l) T_l = 8 sum_{l>=1} S_l.
#pragma unroll 1
  for (int j = 0; j < RED_LANE_SHIFT; j++) g1_double(run, run);
  if (lane == 0) g1_identity(run);
  g1_add(u, u, run);
#pragma unroll 1
  for (int s = 16; s > 0; s >>= 1) {
    G1 q;
    g1_shfl_xor(q, u, s);
    g1_add(u, u, q);
  }
#pragma unroll 1
  for (int j = 0; j < RED_C * w; j++) g1_double(u, u);
  if (lane == 0) g1_store(part + w * G1_WORDS, u);
  // The last window to finish sums them all.
  __threadfence();
  unsigned last = 0;
  if (lane == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  g1_load_cg(u, part + lane * G1_WORDS);  // RED_WINDOWS == 32: one sum per lane
#pragma unroll 1
  for (int s = 16; s > 0; s >>= 1) {
    G1 q;
    g1_shfl_xor(q, u, s);
    g1_add(u, u, q);
  }
  if (lane == 0) g1_store(out, u);
}
static_assert(RED_WINDOWS == 32 && RED_PER_LANE == 1 << RED_LANE_SHIFT, "one window sum per lane");

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

// pts (nproofs, n, 3, 8) projective Montgomery words, scalars (nproofs, n, 8)
// canonical words -> out (nproofs, 3, 8).
extern "C" int svt_msm_windowed(const void* pts, const void* scalars, long long nproofs, int n,
                                void* out, void* stream) {
  if (nproofs > 0 && n >= 0)
    svt::msm_windowed_kernel<<<(unsigned)nproofs, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pts, (const uint32_t*)scalars, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// buckets (32, 256, 3, 8) bucket sums -> out (1, 3, 8).  part: scratch of
// 32 points plus one word (the ticket) after them.
extern "C" int svt_bucket_reduce(const void* buckets, void* part, void* out, void* stream) {
  const auto st = (cudaStream_t)stream;
  auto* ticket = (unsigned*)((uint32_t*)part + svt::RED_WINDOWS * svt::G1_WORDS);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  svt::bucket_reduce_kernel<<<svt::RED_WINDOWS, 32, 0, st>>>(
      (const uint32_t*)buckets, (uint32_t*)part, ticket, (uint32_t*)out);
  return (int)cudaGetLastError();
}
