// The two host loops that drove the point kernels one group operation per
// launch, each moved onto the card as one kernel whose accumulators stay on
// chip from the first window to the last (Hopper, sm_90a; plain C
// interface, ctypes: _build.py, msm/cuda_ops.py, msm/pippenger.py):
//
// * svt_msm_windowed replaces the loop of msm/cuda_ops.py::msm_windowed_plain
//   (its tree_sum included): the verify path's MSM, the JAX package's
//   ec/curve.py::CurveOps.msm_windowed (:194) and ::tree_sum (:245).
//   acc_b = sum_i k[b,i] P[b,i].
// * svt_bucket_reduce replaces msm/pippenger.py::bucket_reduce_plain: the
//   2^20 MSM's weighted bucket sums and window combine, the JAX package's
//   msm/pippenger.py::_weighted_bucket_sum (:276) and ::_horner (:284).
//   sum_w 2^(8w) sum_b b B[w,b] over (32, 256) bucket sums.
//
// What bounds them.  Not bytes (a few MB), and not the card's multiply rate
// as the reference counts the work: a verify batch of 1,024 proofs is 3.6 M
// multiply-adds a proof, 0.22 ms of the whole card.  Chains of group
// operations that no other lane can share: the bucket reduction's top
// window scales its sum by 2^248, 248 doublings in a row; a ladder runs 31
// windows of 4 doublings and two adds.  Each group operation is itself two
// layers of independent Fq products (g1.cuh), so both kernels run their
// operations on teams of T lanes (g1_team.cuh: a team runs a layer's
// products at once), which cuts a double's dependent multiplies from 8 to
// 2 and an add's from 12 to 2 (T = 6) or 4 (T = 4):
//
// * msm_windowed: one ladder a team.  A team owns base i of proof b (then
//   i + tp, ... when a proof has more bases than `tp`, its teams).  It
//   splits the scalar by the curve's endomorphism (GLV, ec/glv.py):
//   k = k1 + lambda k2 (mod r), |k1|, |k2| < 2^127, phi(x, y) = (beta x, y)
//   = lambda P, and runs one ladder over both halves' 32 windows of 4 bits,
//   MSB first: 4 doublings of its accumulator, then the adds of T[d1] and
//   phi(T[d2]), T[d] = d (±P) (16 points of local memory by 14 adds; T[0]
//   the identity, which the complete formulas add with no branch) and
//   phi(T[d]) = (beta X, ±Y, Z) formed at the lookup (y negated where the
//   halves' signs differ).  Half the 64 windows' doublings of the plain
//   ladder, for one add and one product a window more: the chain of one
//   ladder on a lane falls from 3,012 dependent multiplies to 2,032 at
//   n = 26.  A block holds `per_block` whole proofs, their teams laid over
//   its lanes back to back (no lane idles for a proof of 26 bases), and
//   sums each proof's ladders with a tree of team adds through shared
//   memory.  The wrapper picks T and per_block from the batch and the card
//   (cuda_ops.msm_windowed_layout): T = 1 where the ladders alone fill the
//   card and the multiply pipes, not a chain's latency, set the time (the
//   verify batch of 1,024); a team where a few proofs leave the card idle
//   (the tree's fold levels, B = 1).  Every T is the same kernel; T = 1
//   runs g1.cuh's formulas on a lane.
// * bucket_reduce: one block a window, 32 teams.  Team l owns buckets
//   8l .. 8l+7 and forms T_l = sum_k B_{8l+k} and U_l = sum_k k B_{8l+k} by
//   running sums; the window's sum is sum_l U_l + 8 sum_l l T_l, and
//   sum_l l T_l = sum_{l>=1} S_l with S_l = sum_{m>=l} T_m, a suffix scan
//   through shared memory.  Team l adds 8 S_l (team 0: nothing) to U_l, an
//   xor tree sums the teams, and team 0 scales its window's sum by 2^(8w)
//   with 8w team doublings.  The last block to finish (an atomic ticket)
//   sums the 32 scaled window sums with one more tree.  Its time is the
//   top window's chain: 29 adds and 251 doublings, 2,356 dependent
//   multiplies on one lane, 2 x (29 + 251) = 560 on a team of 6 (RED_T:
//   4 x 29 + 2 x 251 = 618 on a team of 4 measured 3% slower).
//
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the runs.)
//
// Results equal the plain versions as points; the order of the sums
// differs, so projective words may not.  Every value stays in the lazy
// [0, 2p] contract of fq.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "g1_team.cuh"

namespace svt {

constexpr int MSMW_BITS = 4;                    // window width (c = 4)
constexpr int MSMW_WINDOWS = 128 / MSMW_BITS;   // 32 windows of a GLV half, |k_i| < 2^127
constexpr int MSMW_TABLE = 1 << MSMW_BITS;      // T[0] .. T[15]
constexpr int MSMW_MAX_WARPS = 8;               // a block's warps at most

constexpr int RED_C = 8;                          // window width of the MSM (c = 8)
constexpr int RED_WINDOWS = (256 + RED_C - 1) / RED_C;  // 32
constexpr int RED_BUCKETS = 1 << RED_C;           // 256
constexpr int RED_TEAMS = 32;                     // teams a window
constexpr int RED_PER_TEAM = RED_BUCKETS / RED_TEAMS;   // 8 buckets a team
constexpr int RED_TEAM_SHIFT = 3;                 // log2(RED_PER_TEAM)
constexpr int RED_T = 6;                          // lanes a team

// Teams of T lanes in a warp: 32 / T whole ones, and (T = 6) a ragged one
// of 32 % T lanes whose work is dropped.
template <int T>
__host__ __device__ constexpr int team_whole() { return 32 / T; }
template <int T>
__host__ __device__ constexpr int team_slots() { return (32 + T - 1) / T; }

// The GLV split of ec/glv.py (its kernel_constants(), least significant
// word first): BETA in Montgomery form; the rounding constants G1, G2; the
// basis A1, A2, -B1, B2.
static __constant__ uint32_t GLV_BETA[FQ_WORDS] = {
    0xd782e155u, 0x71930c11u, 0xffbe3323u, 0xa6bb947cu,
    0xd4741444u, 0xaa303344u, 0x26594943u, 0x2c3b3f0du};
static __constant__ uint32_t GLV_G1[3] = {0xc7e0b3d7u, 0xd91d232eu, 0x00000002u};
static __constant__ uint32_t GLV_G2[5] = {0x391eb18eu, 0x7a7bd9d4u, 0xa773d2cfu, 0x4ccef014u,
                                          0x00000002u};
static __constant__ uint32_t GLV_A1[2] = {0x94d213e3u, 0x89d32568u};
static __constant__ uint32_t GLV_A2[4] = {0x1221250bu, 0x0be4e154u, 0xeeb859fdu, 0x6f4d8248u};
static __constant__ uint32_t GLV_NB1[4] = {0x7d4f1128u, 0x8211bbebu, 0xeeb859fcu, 0x6f4d8248u};
static __constant__ uint32_t GLV_B2[2] = {0x94d213e3u, 0x89d32568u};

// r[0 .. NA + NB) = a * b, schoolbook over 64-bit columns.
template <int NA, int NB>
__device__ __forceinline__ void glv_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < NA + NB; i++) r[i] = 0u;
#pragma unroll
  for (int i = 0; i < NA; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NB; j++) {
      c += (uint64_t)a[i] * b[j] + r[i + j];
      r[i + j] = (uint32_t)c;
      c >>= 32;
    }
    r[i + NB] = (uint32_t)c;
  }
}

// c = round(k G / 2^256) = (k G + 2^255) >> 256 for a G of NG words.
template <int NG>
__device__ __forceinline__ void glv_round(uint32_t* c, const uint32_t k[FQ_WORDS],
                                          const uint32_t* g) {
  uint32_t t[FQ_WORDS + NG];
  glv_mul<FQ_WORDS, NG>(t, k, g);
  uint64_t carry = (uint64_t)t[FQ_WORDS - 1] + 0x80000000u;
#pragma unroll
  for (int i = 0; i < NG; i++) {
    carry = (carry >> 32) + t[FQ_WORDS + i];
    c[i] = (uint32_t)carry;
  }
}

// v (9 words, two's complement) -> |v| in m (4 words: |v| < 2^127) and its sign.
__device__ __forceinline__ bool glv_magnitude(uint32_t m[4], const uint32_t v[9]) {
  const bool neg = v[8] >> 31;
  uint64_t c = neg;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    c += neg ? ~v[i] : v[i];
    m[i] = (uint32_t)c;
    c >>= 32;
  }
  return neg;
}

// k (8 canonical words) -> |k1|, |k2| and their signs, k1 + lambda k2 = k
// (mod r): ec/glv.py::split, word for word.
__device__ __forceinline__ void glv_split(const uint32_t k[FQ_WORDS], uint32_t m1[4], bool& n1,
                                          uint32_t m2[4], bool& n2) {
  uint32_t c1[3], c2[5], u[9], v[9], d[9];
  glv_round<3>(c1, k, GLV_G1);
  glv_round<5>(c2, k, GLV_G2);
  // k1 = k - c1 A1 - c2 A2 (mod 2^288)
  glv_mul<3, 2>(u, c1, GLV_A1);  // 5 words
  glv_mul<5, 4>(v, c2, GLV_A2);  // 9 words
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    c += (int64_t)(i < FQ_WORDS ? k[i] : 0u) - (i < 5 ? u[i] : 0u) - v[i];
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  n1 = glv_magnitude(m1, d);
  // k2 = c1 (-B1) - c2 B2
  glv_mul<3, 4>(u, c1, GLV_NB1);  // 7 words
  glv_mul<5, 2>(v, c2, GLV_B2);   // 7 words
  c = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    c += (int64_t)(i < 7 ? u[i] : 0u) - (i < 7 ? v[i] : 0u);
    d[i] = (uint32_t)c;
    c >>= 32;
  }
  n2 = glv_magnitude(m2, d);
}

// Digit w (4 bits) of a GLV half's magnitude (4 words; selects keep m in
// registers).
__device__ __forceinline__ int msmw_digit(const uint32_t m[4], int w) {
  const int i = w >> 3;
  const uint32_t word = i == 0 ? m[0] : i == 1 ? m[1] : i == 2 ? m[2] : m[3];
  return (int)((word >> (4 * (w & 7))) & 15u);
}

// A block of per_block proofs: team g (of per_block * tp, 32 / T a warp)
// runs the ladders of bases t, t + tp, ... of proof g / tp, t = g % tp.
template <int T, class X = G1SharedExchange>
__global__ void __launch_bounds__(MSMW_MAX_WARPS * 32)
    msm_windowed_kernel(const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc,
                        long long nproofs, int n, int per_block, int tp,
                        uint32_t* __restrict__ out) {
  constexpr int W = team_whole<T>();
  __shared__ G1TeamSlots slots[T == 1 ? 1 : MSMW_MAX_WARPS * team_slots<T>()];
  __shared__ G1 part[MSMW_MAX_WARPS * W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / T, r = lane - slot * T;
  const bool whole = slot < W;
  const int g = warp * W + (whole ? slot : 0);
  const X x(slots[T == 1 ? 0 : warp * team_slots<T>() + slot], lane - r);
  const int q = g / tp, t = g - q * tp;
  const long long b = (long long)blockIdx.x * per_block + q;
  const bool mine = whole && q < per_block && b < nproofs;
  G1 sum;
  g1_identity(sum);
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += tp) {  // every team of the block runs as many ladders
    const int i = i0 + t;
    const bool live = mine && i < n;  // a dead team holds the identity's table
    const long long at = live ? b * n + i : 0;
    // k = k1 + lambda k2: T[d] = d (±P); the second half's entry is
    // phi(T[d]) = (beta X, Y, Z), y negated where the halves' signs differ,
    // formed at each lookup: a second table of local memory made the team
    // kernels slower and their compile take minutes (PERF.md).
    uint32_t k[FQ_WORDS], m1[4], m2[4];
    bool n1, n2;
#pragma unroll
    for (int j = 0; j < FQ_WORDS; j++) k[j] = live ? __ldg(sc + at * FQ_WORDS + j) : 0u;
    glv_split(k, m1, n1, m2, n2);
    G1 tab[MSMW_TABLE];
    g1_identity(tab[0]);
    if (live)
      g1_load_nc(tab[1], pts + at * G1_WORDS);
    else
      g1_identity(tab[1]);
    if (n1) fe_neg<FQ>(tab[1].y, tab[1].y);
#pragma unroll 1
    for (int d = 2; d < MSMW_TABLE; d++) g1_team_add<T>(tab[d], tab[d - 1], tab[1], x, r);
    G1 acc;
    g1_identity(acc);
#pragma unroll 1
    for (int w = MSMW_WINDOWS - 1; w >= 0; w--) {
      if (w < MSMW_WINDOWS - 1) {
#pragma unroll 1
        for (int j = 0; j < MSMW_BITS; j++) g1_team_double<T>(acc, acc, x, r);
      }
      g1_team_add<T>(acc, acc, tab[msmw_digit(m1, w)], x, r);
      G1 phi = tab[msmw_digit(m2, w)];
      fq_mul(phi.x, phi.x, GLV_BETA);
      if (n1 != n2) fe_neg<FQ>(phi.y, phi.y);
      g1_team_add<T>(acc, acc, phi, x, r);
    }
    g1_team_add<T>(sum, sum, acc, x, r);
  }
  // Each proof's tp sums: a tree, level d adding team t + d into team t
  // (t a multiple of 2d).  Every team runs every add; only those of the
  // tree keep theirs.
  if (whole && r == 0) part[g] = sum;
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < tp; d <<= 1) {
    const bool adds = mine && (t & (2 * d - 1)) == 0 && t + d < tp;
    const G1 other = part[adds ? g + d : g];
    G1 res;
    g1_team_add<T>(res, sum, other, x, r);
    if (adds) sum = res;
    __syncthreads();
    if (adds && r == 0) part[g] = sum;
    __syncthreads();
  }
  if (mine && t == 0 && r == 0) g1_store(out + b * G1_WORDS, sum);
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

// v = the sum of every team's v, by an xor tree through shared memory sums
// (team l adds team l ^ m's value, m = 16 .. 1, as a warp's shuffle tree
// would); l = the team, `real` whether it is one of the 32.
template <int T, class X>
__device__ __forceinline__ void red_xor_tree(G1& v, G1* sums, int l, bool real, const X& x,
                                             int r) {
#pragma unroll 1
  for (int m = RED_TEAMS / 2; m > 0; m >>= 1) {
    if (real && r == 0) sums[l] = v;
    __syncthreads();
    const G1 o = sums[l ^ m];
    __syncthreads();
    g1_team_add<T>(v, v, o, x, r);
  }
}

// A block a window: RED_TEAMS teams of T lanes (and, T = 6, the rest of
// the last warp, whose work is dropped).
template <int T>
__host__ __device__ constexpr int red_warps() {
  return (RED_TEAMS + team_whole<T>() - 1) / team_whole<T>();
}

template <int T, class X = G1SharedExchange>
__global__ void __launch_bounds__(red_warps<T>() * 32)
    bucket_reduce_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ part,
                         unsigned* __restrict__ ticket, uint32_t* __restrict__ out) {
  constexpr int W = team_whole<T>();
  __shared__ G1TeamSlots slots[T == 1 ? 1 : red_warps<T>() * team_slots<T>()];
  __shared__ G1 sums[RED_TEAMS];
  __shared__ unsigned last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / T, r = lane - slot * T;
  const int g = warp * W + slot;
  const bool real = slot < W && g < RED_TEAMS;
  const int l = real ? g : 0;  // a team past the 32 works on team 0's buckets
  const X x(slots[T == 1 ? 0 : warp * team_slots<T>() + slot], lane - r);
  const int w = blockIdx.x;
  const uint32_t* blk = buckets + ((long long)w * RED_BUCKETS + l * RED_PER_TEAM) * G1_WORDS;
  // Running sums over the team's block, top bucket first: after bucket k,
  // run = sum_{j>=k} B_j and u = sum_{j>=k} (j - k + 1) B_j; after k = 1,
  // u = sum_k k B_k, and run + B_0 = T_l.
  G1 run, u, bk;
  g1_load_nc(run, blk + (RED_PER_TEAM - 1) * G1_WORDS);
  u = run;
#pragma unroll 1
  for (int k = RED_PER_TEAM - 2; k >= 1; k--) {
    g1_load_nc(bk, blk + k * G1_WORDS);
    g1_team_add<T>(run, run, bk, x, r);
    g1_team_add<T>(u, u, run, x, r);
  }
  g1_load_nc(bk, blk);
  g1_team_add<T>(run, run, bk, x, r);
  // Suffix scan over the teams: run becomes S_l = sum_{m>=l} T_m.
#pragma unroll 1
  for (int d = 1; d < RED_TEAMS; d <<= 1) {
    if (real && r == 0) sums[l] = run;
    __syncthreads();
    const G1 o = sums[l + d < RED_TEAMS ? l + d : l];
    __syncthreads();
    G1 res;
    g1_team_add<T>(res, run, o, x, r);
    if (l + d < RED_TEAMS) run = res;
  }
  // Team weights: sum_l (8l) T_l = 8 sum_{l>=1} S_l.
#pragma unroll 1
  for (int j = 0; j < RED_TEAM_SHIFT; j++) g1_team_double<T>(run, run, x, r);
  if (l == 0) g1_identity(run);
  g1_team_add<T>(u, u, run, x, r);
  red_xor_tree<T>(u, sums, l, real, x, r);
  // Team 0 (warp 0) scales the window's sum by 2^(8w).
  if (warp == 0) {
#pragma unroll 1
    for (int j = 0; j < RED_C * w; j++) g1_team_double<T>(u, u, x, r);
    if (lane == 0) g1_store(part + w * G1_WORDS, u);
  }
  // The last window to finish sums them all.
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  g1_load_cg(u, part + l * G1_WORDS);  // RED_WINDOWS == RED_TEAMS: one sum a team
  red_xor_tree<T>(u, sums, l, real, x, r);
  if (threadIdx.x == 0) g1_store(out, u);
}
static_assert(RED_WINDOWS == RED_TEAMS && RED_PER_TEAM == 1 << RED_TEAM_SHIFT,
              "one window sum a team");

template <int T, class X = G1SharedExchange>
int launch_msm_windowed(const void* pts, const void* scalars, long long nproofs, int n,
                        int per_block, void* out, cudaStream_t st) {
  const int max_teams = MSMW_MAX_WARPS * team_whole<T>();
  if (per_block < 1 || per_block > max_teams) return (int)cudaErrorInvalidValue;
  const int tp = n < 1 ? 1 : (n < max_teams / per_block ? n : max_teams / per_block);
  const int warps = (per_block * tp + team_whole<T>() - 1) / team_whole<T>();
  const long long blocks = (nproofs + per_block - 1) / per_block;
  msm_windowed_kernel<T, X><<<(unsigned)blocks, warps * 32, 0, st>>>(
      (const uint32_t*)pts, (const uint32_t*)scalars, nproofs, n, per_block, tp,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace svt
