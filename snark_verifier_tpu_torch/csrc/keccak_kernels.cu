// svt_keccak_read: a batch's whole EVM (keccak) transcript read in one
// launch, for Hopper (sm_90a), bound through a plain C interface (ctypes,
// see _build.py and hash/keccak_device.py::read and ::squeeze).
//
// It replaces the JAX package's hash/keccak_device.py::keccak_f (:82) and
// keccak256_words (:137), which XLA runs as a 24-step lax.scan over (lo, hi)
// uint32 lane pairs, together with the transcript's word codec and
// from_mont (transcript/evm_transcript.py::EvmTranscript, :114-134).  Torch
// has no 64-bit rotation on unsigned lanes and no 256-bit modular multiply.
//
// A read is a schedule recorded once per protocol (verifier/plonk/plan.py):
// squeeze q hashes rows starts[q] .. starts[q + 1] - 1, each row a word's
// source (an instance, a constant, a stream scalar, the x or y of a stream
// point, the hash of an earlier squeeze, or the x or y of a lane point: an
// instance commitment, computed before the read and normalised to affine
// by svt_points_to_fr), its index there and its tag:
// 0 raw bytes (hashed as they are), 1 an Fr and 2 an Fq element in
// Montgomery form (they leave it through fq.cuh's multiply by plain 1 and
// fe_canon).  Each squeeze is keccak256 of its words, the dup marker 0x01
// after a lone word (transcript/evm.rs:88) and the keccak pad, whose lanes
// depend on the word count alone (keccak_device.py::pad_lanes, one table of
// every squeeze's).  Out: every squeeze's hash (raw words) and challenge
// (the hash mod r, Montgomery form), (n_sq, B, 8) each.  A single squeeze of
// given words (EvmTranscript.squeeze_challenge) is a schedule of one.
//
// Design: a warp per proof, KR_TEAMS warps a block, so a batch of 1,024
// is 1,024 warps, ~8 on each of the 132 SMs.  A squeeze's words are gathered
// and leave Montgomery form one word a lane (32 at a time), into a ring of
// sponge lanes in shared memory; then the warp absorbs block after block of
// 17 lanes, lane i XORing sponge lane i, and runs keccak.cuh's team
// permutation, a 64-bit sponge lane a thread.  Lanes 0..3 hold the hash
// after the last block and write it out; a later squeeze reads it back as a
// raw word.  At the end each lane turns one squeeze's hash into its
// challenge: fq.cuh's fe_mul<FR> with R^2 = 2^512 mod r as the multiplicand
// and the hash as the multiplier, (R^2 h + m r) / R, the JAX package's
// `FR_FIELD.mul(h, R2)` word for word (the product is a function of R^2 h
// alone).  The hash may be any 256-bit value (up to ~5.3 r), outside
// fe_mul's [0, 2r] inputs, but the carries hold: word-serial Montgomery
// keeps every row below (a + r) 2^32 for the multiplicand a, whatever the
// multiplier, and a = R^2 < r gives < 2^288, so the result lies in [0, 2r)
// (tests/test_torch_keccak_schedule.py runs fe_mul's carry chains on 0,
// r - 1, r, 2r, 5r and 2^256 - 1).
//
// Bound.  The bytes are tiny, so the bound is the operations: a round needs
// at least 178 32-bit logic instructions for a whole state (theta's column
// parities 20 LOP3, the rotations of its parities 10 SHF, and
// a ^ C[x-1] ^ rotl(C[x+1], 1) one LOP3 a half of each of the 25 lanes, 50;
// rho's 48 SHF; chi's 50 LOP3), iota an XOR per nonzero half of its
// constant, 24 rounds a block (chip_smoke.py's KECCAK_OPS_PER_ROUND).  The
// chain floor is a round's critical path on the team: four dependent
// shuffles (the column's parity, D, pi, chi) at their latency beside the
// dependent integer instructions between them, times 24 rounds and the
// blocks a proof (chip_smoke.py's KECCAK_TEAM_ROUND_CLOCKS).

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"
#include "keccak.cuh"

namespace svt {

constexpr int KR_TEAMS = 4;    // warps (proofs) a block
constexpr int KR_RING = 256;   // sponge lanes a warp buffers (a power of two)
constexpr int KR_CHUNK = 32;   // words gathered at a time, one a lane
constexpr int KC_TAG_FR = 1, KC_TAG_FQ = 2;  // tag 0: raw words, hashed as they are
enum { KC_SRC_INSTANCE, KC_SRC_CONST, KC_SRC_SCALAR, KC_SRC_POINT_X, KC_SRC_POINT_Y,
       KC_SRC_HASH, KC_SRC_LANE_X, KC_SRC_LANE_Y };

struct KcRead {
  const uint32_t* inst;     // (B, n_inst, 8) Fr Montgomery words
  int n_inst;
  const uint32_t* consts;   // (n_consts, 8)
  const uint32_t* scalars;  // (B, n_sc, 8) Fr Montgomery words, the proof stream's
  int n_sc;
  const uint32_t* points;   // (B, n_pt, 2, 8) affine Fq Montgomery words
  int n_pt;
  const uint32_t* lane_pts;  // (B, n_lane_pts, 2, 8) affine Fq Montgomery words
  int n_lane_pts;
  const int* rows;          // (n_rows, 3): source, index, tag
  const int* starts;        // (n_sq + 1,): squeeze q's rows
  const uint32_t* pad;      // (L, 2): (lo, hi) halves of every squeeze's pad lanes
  const int* pad_starts;    // (n_sq + 1,): squeeze q's pad lanes
  int n_sq;
  uint32_t* hash;           // (n_sq, B, 8) raw words
  uint32_t* chal;           // (n_sq, B, 8) Fr Montgomery words
  long long B;
};

__device__ __forceinline__ void kr_load(uint32_t x[FQ_WORDS], const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const uint4 lo = s[0], hi = s[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// Row r's word for proof b, out of Montgomery form where tagged.
__device__ __forceinline__ void kr_word(uint32_t x[FQ_WORDS], const KcRead& s, int r,
                                        long long b) {
  const int src = s.rows[3 * r], idx = s.rows[3 * r + 1], tag = s.rows[3 * r + 2];
  const uint32_t* p =
      src == KC_SRC_INSTANCE ? s.inst + (b * s.n_inst + idx) * FQ_WORDS
      : src == KC_SRC_CONST  ? s.consts + (long long)idx * FQ_WORDS
      : src == KC_SRC_SCALAR ? s.scalars + (b * s.n_sc + idx) * FQ_WORDS
      : src == KC_SRC_HASH   ? s.hash + (idx * s.B + b) * FQ_WORDS
      : src >= KC_SRC_LANE_X ? s.lane_pts + ((b * s.n_lane_pts + idx) * 2
                                              + (src == KC_SRC_LANE_Y)) * FQ_WORDS
                             : s.points + ((b * s.n_pt + idx) * 2 + (src == KC_SRC_POINT_Y))
                                              * FQ_WORDS;
  kr_load(x, p);
  if (tag == KC_TAG_FR || tag == KC_TAG_FQ) {
    const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    uint32_t t[FQ_WORDS];
    if (tag == KC_TAG_FR) {
      fe_mul<FR>(t, x, one);  // from_mont
      fe_canon<FR>(x, t);
    } else {
      fe_mul<FQ>(t, x, one);
      fe_canon<FQ>(x, t);
    }
  }
}

__global__ void __launch_bounds__(KR_TEAMS * 32) keccak_read_kernel(const KcRead s) {
  __shared__ uint64_t ring_all[KR_TEAMS][KR_RING];
  const int lane = threadIdx.x & 31, team = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * KR_TEAMS + team;
  if (b >= s.B) return;  // the whole warp
  uint64_t* ring = ring_all[team];
  const KcTeamLane me = kc_team_lane(lane);
#pragma unroll 1
  for (int q = 0; q < s.n_sq; q++) {
    const int r0 = s.starts[q], W = s.starts[q + 1] - r0;
    const int p0 = s.pad_starts[q];
    const int n_word_lanes = 4 * W, n_lanes = n_word_lanes + s.pad_starts[q + 1] - p0;
    uint64_t st = 0;
    int blk = 0;
    // Chunk c's 128 lanes go to ring slots 128c .. 128c + 127 (mod 256);
    // the unread ones then start at 128c - 16 or later: no overwrite.
#pragma unroll 1
    for (int c0 = 0; c0 < W; c0 += KR_CHUNK) {
      if (c0 + lane < W) {
        uint32_t x[FQ_WORDS];
        kr_word(x, s, r0 + c0 + lane, b);
        uint64_t l[4];
        kc_word_to_lanes(x, l);
#pragma unroll
        for (int i = 0; i < 4; i++) ring[(4 * (c0 + lane) + i) & (KR_RING - 1)] = l[i];
      }
      __syncwarp();
      const int avail = c0 + KR_CHUNK >= W ? n_lanes : 4 * (c0 + KR_CHUNK);
#pragma unroll 1
      for (; KC_RATE * (blk + 1) <= avail; blk++) {
        const int g = KC_RATE * blk + lane;
        if (lane < KC_RATE) {
          const int p = p0 + g - n_word_lanes;
          st ^= g < n_word_lanes ? ring[g & (KR_RING - 1)]
                                 : ((uint64_t)s.pad[2 * p + 1] << 32) | s.pad[2 * p];
        }
        kc_team_permute(st, me);
      }
      __syncwarp();
    }
    if (lane < 4) {  // hash lane `lane` is chunk 3 - lane of the value, byte-reversed
      uint32_t* h = s.hash + (q * s.B + b) * FQ_WORDS + 2 * (3 - lane);
      h[0] = kc_bswap32((uint32_t)(st >> 32));
      h[1] = kc_bswap32((uint32_t)st);
    }
    __syncwarp();
  }
  const uint32_t r2[FQ_WORDS] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                                 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};  // R^2 mod r
#pragma unroll 1
  for (int q = lane; q < s.n_sq; q += 32) {
    uint32_t h[FQ_WORDS], c[FQ_WORDS];
    kr_load(h, s.hash + (q * s.B + b) * FQ_WORDS);
    fe_mul<FR>(c, r2, h);  // the challenge: h R mod r, in [0, 2r)
    uint4* dc = reinterpret_cast<uint4*>(s.chal + (q * s.B + b) * FQ_WORDS);
    dc[0] = make_uint4(c[0], c[1], c[2], c[3]);
    dc[1] = make_uint4(c[4], c[5], c[6], c[7]);
  }
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  The arrays are KcRead's; the host
// (keccak_device.py::ReadSchedule) checks every row's index against its
// source and that every squeeze has at least one word.
extern "C" int svt_keccak_read(const void* inst, int n_inst, const void* consts,
                               const void* scalars, int n_sc, const void* points, int n_pt,
                               const void* lane_pts, int n_lane_pts, const void* rows,
                               const void* starts, const void* pad,
                               const void* pad_starts, int n_sq, void* hash, void* chal,
                               long long B, void* stream) {
  if (n_sq < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const svt::KcRead s{(const uint32_t*)inst, n_inst, (const uint32_t*)consts,
                      (const uint32_t*)scalars, n_sc, (const uint32_t*)points, n_pt,
                      (const uint32_t*)lane_pts, n_lane_pts, (const int*)rows,
                      (const int*)starts, (const uint32_t*)pad,
                      (const int*)pad_starts, n_sq, (uint32_t*)hash, (uint32_t*)chal, B};
  const unsigned blocks = (unsigned)((B + svt::KR_TEAMS - 1) / svt::KR_TEAMS);
  svt::keccak_read_kernel<<<blocks, svt::KR_TEAMS * 32, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
