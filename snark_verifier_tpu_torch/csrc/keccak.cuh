// Keccak-256 pieces for the EVM transcript's read (keccak_kernels.cu):
// tests/test_torch_keccak_schedule.py compiles this very text with g++ (a
// thread a lane, a shuffle through a barrier) and holds it against python
// ints.
//
// * kc_team_permute: keccak-f[1600] by a warp, a 64-bit sponge lane a
//   thread (lane i at x = i % 5, y = i / 5), its 24 rounds unrolled so that
//   every round constant is an immediate; the lanes meet by __shfl_sync.
//   Each chi term x ^ (~y & z) is one three-input LOP3 per 32-bit half.
// * kc_word_to_lanes / kc_lanes_to_word: a canonical 256-bit value in the
//   port's 8 little-endian 32-bit words <-> the four sponge lanes of its
//   32-byte big-endian encoding.  Lane i is the byte-reversed 64-bit chunk
//   3 - i of the value.

#pragma once

#include <cstdint>

namespace svt {

constexpr int KC_LANES = 25;
constexpr int KC_RATE = 17;  // lanes of a 136-byte sponge block
constexpr int KC_ROUNDS = 24;

__host__ __device__ constexpr uint64_t kc_round_constant(int r) {
  constexpr uint64_t rc[KC_ROUNDS] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  return rc[r];
}

// x rotated left by n, 0 < n < 64.
__host__ __device__ __forceinline__ uint64_t kc_rotl(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

// chi's term: x ^ (~y & z).
__host__ __device__ __forceinline__ uint64_t kc_chi(uint64_t x, uint64_t y, uint64_t z) {
  return x ^ (~y & z);
}

__host__ __device__ __forceinline__ uint32_t kc_bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0u, 0x0123u);
#else
  return __builtin_bswap32(x);
#endif
}

// ---- keccak-f[1600] by a team of lanes ----------------------------------
//
// One warp holds one state: lane t < 25 holds sponge lane t (x = t % 5,
// y = t / 5) as a 64-bit value; lanes 25..31 mirror lanes 0..6 (they
// compute, nobody reads them), so every shuffle runs with the full mask.  A
// round, for each lane:
//   theta  C[x] = its column's five lanes (four shuffles of the other rows),
//          D[x] = C[x-1] ^ rotl(C[x+1], 1) (two shuffles), a ^= D[x];
//   rho+pi the lane takes its pi source's value (one shuffle) and rotates it
//          by that source's rho offset (a per-lane amount, fixed for the
//          kernel: one select of the halves, two funnel shifts);
//   chi    a ^= ~b[x+1] & b[x+2] of its row (two shuffles);
//   iota   lane 0 XORs the round constant (an immediate: rounds unrolled).
// A 64-bit shuffle is two 32-bit ones: 18 shuffles a round, 4 of them on
// the round's critical path (parities, D, pi, chi) beside ~12 dependent
// integer instructions.

// rho's offset of lane i (x = i % 5, y = i / 5).
__host__ __device__ constexpr int kc_rho(int i) {
  constexpr int rho[KC_LANES] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                 25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  return rho[i];
}

// rotl(hi:lo, m) for 0 <= m < 32, one half at a time: the high 32 bits of
// (hi:lo) << m.
__host__ __device__ __forceinline__ uint32_t kc_funnel(uint32_t lo, uint32_t hi, int m) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, m);
#else
  return m ? (hi << m) | (lo >> (32 - m)) : hi;
#endif
}

// A lane's fixed part of the team permutation.
struct KcTeamLane {
  int col[4];     // the other four lanes of its column
  int left;       // lane x - 1 of its row
  int right;      // lane x + 1 of its row
  int right2;     // lane x + 2 of its row
  int src;        // pi: the lane whose value it takes
  int rot;        // rho's offset of that value, mod 32 ...
  bool rot_swap;  // ... after swapping the halves when the offset is >= 32
  bool iota;      // lane 0
};

__host__ __device__ __forceinline__ KcTeamLane kc_team_lane(int t) {
  const int i = t < KC_LANES ? t : t - KC_LANES;
  const int x = i % 5, y = i / 5;
  KcTeamLane m;
#pragma unroll
  for (int k = 1; k < 5; k++) m.col[k - 1] = x + 5 * ((y + k) % 5);
  m.left = (x + 4) % 5 + 5 * y;
  m.right = (x + 1) % 5 + 5 * y;
  m.right2 = (x + 2) % 5 + 5 * y;
  // b[X + 5Y] = rotl(a[x + 5y], rho) with X = y, Y = 2x + 3y: x = X + 3Y.
  m.src = (x + 3 * y) % 5 + 5 * x;
  int r = 0;  // kc_rho(m.src) by selects over immediates: no table in local memory
#pragma unroll
  for (int k = 0; k < KC_LANES; k++) r = k == m.src ? kc_rho(k) : r;
  m.rot = r & 31;
  m.rot_swap = r >= 32;
  m.iota = i == 0;
  return m;
}

__device__ __forceinline__ uint64_t kc_shfl(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// keccak-f[1600] of the warp's state; a is this lane's sponge lane.
__device__ __forceinline__ void kc_team_permute(uint64_t& a, const KcTeamLane& m) {
#pragma unroll
  for (int r = 0; r < KC_ROUNDS; r++) {
    const uint64_t c = a ^ kc_shfl(a, m.col[0]) ^ kc_shfl(a, m.col[1]) ^ kc_shfl(a, m.col[2]) ^
                       kc_shfl(a, m.col[3]);
    const uint64_t d = kc_shfl(c, m.left) ^ kc_rotl(kc_shfl(c, m.right), 1);
    const uint64_t v = kc_shfl(a ^ d, m.src);
    const uint32_t vl = (uint32_t)v, vh = (uint32_t)(v >> 32);
    const uint32_t lo = m.rot_swap ? vh : vl, hi = m.rot_swap ? vl : vh;
    const uint64_t b = ((uint64_t)kc_funnel(lo, hi, m.rot) << 32) | kc_funnel(hi, lo, m.rot);
    a = kc_chi(b, kc_shfl(b, m.right), kc_shfl(b, m.right2));
    a ^= m.iota ? kc_round_constant(r) : 0;
  }
}

// w: a value's 8 little-endian 32-bit words -> l: the four lanes of its
// 32-byte big-endian encoding.
__host__ __device__ __forceinline__ void kc_word_to_lanes(const uint32_t w[8], uint64_t l[4]) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int c = 3 - i;
    l[i] = ((uint64_t)kc_bswap32(w[2 * c]) << 32) | kc_bswap32(w[2 * c + 1]);
  }
}

// The inverse: the four lanes of a 32-byte word -> the value it encodes
// big-endian, as 8 little-endian 32-bit words.
__host__ __device__ __forceinline__ void kc_lanes_to_word(const uint64_t l[4], uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int c = 3 - i;
    w[2 * c] = kc_bswap32((uint32_t)(l[i] >> 32));
    w[2 * c + 1] = kc_bswap32((uint32_t)l[i]);
  }
}

}  // namespace svt
