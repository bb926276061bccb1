// svt_keccak_squeeze: the EVM (keccak) transcript's squeeze for a batch of
// proofs, for Hopper (sm_90a), bound through a plain C interface (ctypes,
// see _build.py and hash/keccak_device.py::squeeze).
//
// It replaces the JAX package's hash/keccak_device.py::keccak_f (:82) and
// keccak256_words (:137), which XLA runs as a 24-step lax.scan over (lo, hi)
// uint32 lane pairs, together with the transcript's word codec and
// from_mont (transcript/evm_transcript.py::EvmTranscript, :114-134).  Torch
// has no 64-bit rotation on unsigned lanes and no 256-bit modular multiply.
//
// One squeeze: keccak256 of the transcript's buffer of W 32-byte words,
// the dup marker 0x01 after a lone word (transcript/evm.rs:88), the keccak
// pad 0x01 ... 0x80; its hash and its challenge (the hash mod r, Montgomery
// form).  Word w carries a tag: 0 raw bytes (the previous squeeze's hash,
// as a value's words), 1 an Fr element and 2 an Fq element in Montgomery
// form, which leave it through fq.cuh's multiply by plain 1 and fe_canon.
// The padding lanes after the words are static per W and computed on the
// host (keccak_device.py::pad_lanes).
//
// Design: a thread per proof, 32 threads a block so that a batch of 1,024
// spreads over 32 SMs.  A thread first turns its W words into sponge lanes
// (from_mont where tagged, the byte-swapping codec of keccak.cuh) and
// parks them in `scratch` (lane-major, so a warp's loads coalesce); then it
// XORs block after block of 17 lanes into the 25-lane state held in
// registers and runs keccak-f[1600] with its 24 rounds unrolled
// (keccak.cuh).  A simple kernel that is right: nothing is shared between
// threads.
//
// The challenge is fq.cuh's fe_mul<FR> with R^2 = 2^512 mod r as the
// multiplicand and the hash as the multiplier: (R^2 h + m r) / R, the JAX
// package's `FR_FIELD.mul(h, R2)` (transcript/evm_transcript.py:131-134)
// word for word, since the product is a function of R^2 h alone.  The hash
// may be any 256-bit value (up to ~5.3 r), outside fe_mul's [0, 2r] inputs,
// but its carries hold: word-serial Montgomery keeps every row's sum below
// (a + r) 2^32 for the multiplicand a, whatever the multiplier's words, and
// a = R^2 < r gives < 2^288, so no carry is lost and the result lies in
// [0, 2r), the lazy contract (tests/test_torch_keccak_schedule.py runs
// fe_mul's carry chains on 0, r - 1, r, 2r, 5r and 2^256 - 1).
//
// Bound.  The bytes are tiny (B (32 W + 64) bytes), so the bound is the
// operations: a round needs at least 178 32-bit logic instructions, a
// three-input LOP3 or a funnel shift (SHF) per 32-bit half (theta's column
// parities 20 LOP3, the rotations of its parities 10 SHF, and
// a ^ C[x-1] ^ rotl(C[x+1], 1) one LOP3 a half of each of the 25 lanes, 50;
// rho's 48 SHF; chi's 50 LOP3), iota an XOR per nonzero half of its
// constant, 24 rounds a block.  At B = 1,024 the card is nearly empty: a
// warp issues one integer instruction every two clocks on its scheduler's
// 16 integer lanes, so a block's 24 rounds cost at least ~8,600 clocks of
// one warp, with the blocks chained (chip_smoke.py's chain floor).

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"
#include "keccak.cuh"

namespace svt {

constexpr int KC_THREADS = 32;
constexpr int KC_TAG_FR = 1, KC_TAG_FQ = 2;  // tag 0: raw words, hashed as they are

__global__ void __launch_bounds__(KC_THREADS)
    keccak_squeeze_kernel(const uint32_t* __restrict__ words, const int* __restrict__ tags,
                          int W, const uint32_t* __restrict__ pad, int L,
                          uint64_t* __restrict__ scratch, uint32_t* __restrict__ hash,
                          uint32_t* __restrict__ chal, long long n) {
  const long long b = (long long)blockIdx.x * KC_THREADS + threadIdx.x;
  if (b >= n) return;
  const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  const uint32_t r2[FQ_WORDS] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                                 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};  // R^2 mod r
  // The buffer's words as lanes: lane 4w + i of word w at scratch[(4w + i) n + b].
#pragma unroll 1
  for (int w = 0; w < W; w++) {
    const uint4* src = reinterpret_cast<const uint4*>(words + (b * W + w) * FQ_WORDS);
    const uint4 lo = src[0], hi = src[1];
    uint32_t x[FQ_WORDS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}, t[FQ_WORDS];
    const int tag = tags[w];
    if (tag == KC_TAG_FR) {
      fe_mul<FR>(t, x, one);  // from_mont
      fe_canon<FR>(x, t);
    } else if (tag == KC_TAG_FQ) {
      fe_mul<FQ>(t, x, one);
      fe_canon<FQ>(x, t);
    }
    uint64_t l[4];
    kc_word_to_lanes(x, l);
#pragma unroll
    for (int i = 0; i < 4; i++) scratch[(4LL * w + i) * n + b] = l[i];
  }
  // The sponge: the word lanes, then the static padding lanes, 17 a block.
  uint64_t st[KC_LANES];
#pragma unroll
  for (int i = 0; i < KC_LANES; i++) st[i] = 0;
  const int n_word_lanes = 4 * W, n_lanes = 4 * W + L;
#pragma unroll 1
  for (int g0 = 0; g0 < n_lanes; g0 += KC_RATE) {
#pragma unroll
    for (int k = 0; k < KC_RATE; k++) {
      const int g = g0 + k;
      const int p = g - n_word_lanes;
      st[k] ^= g < n_word_lanes ? scratch[(long long)g * n + b]
                                : ((uint64_t)pad[2 * p + 1] << 32) | pad[2 * p];
    }
    kc_permute(st);
  }
  uint32_t h[FQ_WORDS], c[FQ_WORDS];
  kc_lanes_to_word(st, h);
  fe_mul<FR>(c, r2, h);  // the challenge: h R mod r, in [0, 2r)
  uint4* dh = reinterpret_cast<uint4*>(hash + b * FQ_WORDS);
  uint4* dc = reinterpret_cast<uint4*>(chal + b * FQ_WORDS);
  dh[0] = make_uint4(h[0], h[1], h[2], h[3]);
  dh[1] = make_uint4(h[4], h[5], h[6], h[7]);
  dc[0] = make_uint4(c[0], c[1], c[2], c[3]);
  dc[1] = make_uint4(c[4], c[5], c[6], c[7]);
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  words (n, W, 8) Montgomery or raw
// words, tags (W,) int32, pad (L, 2) uint32 (lo, hi) lanes with 4 W + L a
// multiple of 17, scratch (4 W, n) uint64; out hash (n, 8) raw words, chal
// (n, 8) Fr Montgomery words.
extern "C" int svt_keccak_squeeze(const void* words, const void* tags, int W, const void* pad,
                                  int L, void* scratch, void* hash, void* chal, long long n,
                                  void* stream) {
  if (W < 1 || L < 1 || (4 * W + L) % svt::KC_RATE || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + svt::KC_THREADS - 1) / svt::KC_THREADS);
  svt::keccak_squeeze_kernel<<<blocks, svt::KC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)tags, W, (const uint32_t*)pad, L,
      (uint64_t*)scratch, (uint32_t*)hash, (uint32_t*)chal, n);
  return (int)cudaGetLastError();
}
