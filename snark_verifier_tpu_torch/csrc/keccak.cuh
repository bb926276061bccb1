// Keccak-256 pieces for the EVM transcript's squeeze (keccak_kernels.cu),
// every function __host__ __device__: tests/test_torch_keccak_schedule.py
// compiles this very text with g++ and holds it against python ints.
//
// * kc_permute: keccak-f[1600] on 25 64-bit lanes (lane i at x = i % 5,
//   y = i / 5), its 24 rounds unrolled so that every lane index, rotation
//   and round constant is a compile-time constant and the state stays in
//   registers.  nvcc turns each 64-bit rotation into two funnel shifts
//   (SHF.L.W) and each chi term x ^ (~y & z) into one three-input LOP3 per
//   32-bit half.
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

// keccak-f[1600] in place.
__host__ __device__ __forceinline__ void kc_permute(uint64_t a[KC_LANES]) {
#pragma unroll
  for (int r = 0; r < KC_ROUNDS; r++) {
    // theta
    uint64_t c[5], d[5], b[KC_LANES];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ kc_rotl(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < KC_LANES; i++) a[i] ^= d[i % 5];
    // rho and pi: b[y + 5 ((2x + 3y) % 5)] = rotl(a[x + 5y], ROT[x][y])
    b[0] = a[0];
    b[1] = kc_rotl(a[6], 44);
    b[2] = kc_rotl(a[12], 43);
    b[3] = kc_rotl(a[18], 21);
    b[4] = kc_rotl(a[24], 14);
    b[5] = kc_rotl(a[3], 28);
    b[6] = kc_rotl(a[9], 20);
    b[7] = kc_rotl(a[10], 3);
    b[8] = kc_rotl(a[16], 45);
    b[9] = kc_rotl(a[22], 61);
    b[10] = kc_rotl(a[1], 1);
    b[11] = kc_rotl(a[7], 6);
    b[12] = kc_rotl(a[13], 25);
    b[13] = kc_rotl(a[19], 8);
    b[14] = kc_rotl(a[20], 18);
    b[15] = kc_rotl(a[4], 27);
    b[16] = kc_rotl(a[5], 36);
    b[17] = kc_rotl(a[11], 10);
    b[18] = kc_rotl(a[17], 15);
    b[19] = kc_rotl(a[23], 56);
    b[20] = kc_rotl(a[2], 62);
    b[21] = kc_rotl(a[8], 55);
    b[22] = kc_rotl(a[14], 39);
    b[23] = kc_rotl(a[15], 41);
    b[24] = kc_rotl(a[21], 2);
    // chi along each row y, then iota
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        a[y + x] = kc_chi(b[y + x], b[y + (x + 1) % 5], b[y + (x + 2) % 5]);
      }
    }
    a[0] ^= kc_round_constant(r);
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
