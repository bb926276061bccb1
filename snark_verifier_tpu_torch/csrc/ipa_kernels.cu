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
// 0).  Out: (2^k, 16) int64 canonical 16-bit limbs, the scalars that
// msm/pippenger.py::msm reads (`scalars_u16`), so no host or torch step
// touches the 2^k scalars.  A canonical word is a function of the value
// alone, so any order of products gives the words of the plain version
// (cuda_ops.py::h_coeffs_plain, the JAX package's doubling order).
//
// Bound at k = 20: the 2^20 outputs of 128 bytes are 134 MB, 0.040 ms at
// 3.35 TB/s; the least operations, one product (136 multiply-adds) and one
// reduction (72) a coefficient, are 2.2e8 multiply-adds, 0.013 ms at
// 16.7e12 per s.  The bytes set the bound, so the design is about the
// stores: they leave the block as contiguous 32 KB bulk copies.
//
// Design.  j's bits fall in chunks of HC_CHUNK_BITS = 5; chunk q's table
// holds the product of its challenges for each of the 32 values of its
// bits, built by doubling in shared memory (5 levels, a barrier each, all
// chunks at once).  Chunk 0 starts from s and stays in Montgomery form,
// chunk 2 starts from a plain 1, so its entries are plain values (a
// Montgomery product of a plain value and a Montgomery one is plain);
// the others hold bare products of challenges in Montgomery form (their
// entry 0, the empty product, is never read).  A tile is 2^10 consecutive
// coefficients: its low bits are chunks 0-1, whose products make the
// table T[lo] = s * P_lo in Montgomery form (one product an entry), and
// its high bits, the tile's index, chunks 2 and up, whose product F is a
// plain value (one product per further nonzero chunk: none below k = 16,
// at most one at k = 20).  So coefficient j = T[lo] * F is one Montgomery
// product, already out of Montgomery form, then fe_canon.
//
// A block of 256 threads builds the tables once, then walks tiles
// blockIdx.x, + gridDim.x, ... (at most two blocks an SM, as the shared
// memory allows), each in four sub-tiles of 256 coefficients: a thread
// makes one coefficient and writes its 16 int64 limbs into a staging
// buffer in shared memory (8 16-byte stores in an order rotated by the
// thread's index, so a quarter warp's stores fall in 8 different bank
// groups), fenced for the async proxy; thread 0 waits until the previous
// sub-tile's copy has read its buffer, a barrier, then thread 0 issues the
// sub-tile's 32 KB as one TMA bulk copy (bulk.cuh).  The staging buffer is
// double, so a copy overlaps the next sub-tile's products, and the one
// barrier a sub-tile orders both.  (PR 13's kernel wrote each
// coefficient's 16 limbs from its own thread: a warp store touched 32
// lines of 128 bytes for 256 useful bytes.  Staging a tile's canonical
// words and storing them 16 bytes a thread, 512 contiguous bytes a warp
// instruction, measured 8% slower than the bulk copies at k = 20:
// csrc/probe/ipa_h_coeffs_vec.cu, kernel_compare.py.)  k below 10 is one
// block and one tile of 2^k.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "fq.cuh"

namespace svt {

constexpr int HC_THREADS = 256;
constexpr int HC_CHUNK_BITS = 5;
constexpr int HC_MAX_K = 30;
constexpr int HC_BLOCKS_PER_SM = 2;  // the shared memory's limit (~102 KB a block)

// The tables of a kernel whose chunks are CB bits: NCHUNK chunk tables of
// 2^CB entries and the tile's table T of 2^TB entries (TB = 2 CB), 8 words
// an entry.
template <int CB>
struct HcShape {
  static constexpr int TB = 2 * CB;
  static constexpr int CW = 1 << CB;
  static constexpr int NCHUNK = (HC_MAX_K + CB - 1) / CB;
  static constexpr int CHUNK_WORDS = NCHUNK * CW * FQ_WORDS;
  static constexpr int TILE_WORDS = (1 << TB) * FQ_WORDS;
  static constexpr int TABLE_BYTES = 4 * (CHUNK_WORDS + TILE_WORDS);
};

// Dynamic shared memory of the kernel: the tables, then two staging
// buffers of THREADS coefficients' int64 limbs (128 bytes each).
template <int THREADS, int CB>
constexpr int hc_smem_bytes() {
  return HcShape<CB>::TABLE_BYTES + 2 * THREADS * 128;
}

__device__ __forceinline__ void hc_load(uint32_t x[FQ_WORDS], const uint32_t* src) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const uint4 lo = s4[0], hi = s4[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void hc_store(uint32_t* dst, const uint32_t x[FQ_WORDS]) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  d4[0] = make_uint4(x[0], x[1], x[2], x[3]);
  d4[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// The block's tables: every chunk's (chunk, (NCHUNK, CW, 8)) and the
// tile's T (table, (2^tb, 8)), from xi (k, 8) and s (8,); ends with a
// barrier.
template <int THREADS, int CB>
__device__ __forceinline__ void hc_tables(const uint32_t* __restrict__ xi,
                                          const uint32_t* __restrict__ s, int k, uint32_t* chunk,
                                          uint32_t* table) {
  using S = HcShape<CB>;
  const int tid = threadIdx.x;
  const int n_lo = 1 << (k < S::TB ? k : S::TB);
  uint32_t x[FQ_WORDS], y[FQ_WORDS], r[FQ_WORDS];

  if (tid == 0) {
    hc_load(x, s);
    hc_store(chunk, x);  // chunk 0, entry 0: s
    const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    hc_store(chunk + 2 * S::CW * FQ_WORDS, one);  // chunk 2, entry 0: a plain 1
  }
  __syncthreads();
  // Level c: entry 2^c + i of every chunk is entry i times the challenge of
  // the chunk's bit c (bit q CB + c of j); a chunk's entry 2^c alone is
  // the bare challenge where the chunk holds bare products.
#pragma unroll 1
  for (int c = 0; c < CB; c++) {
#pragma unroll 1
    for (int it = tid; it < S::NCHUNK << c; it += THREADS) {
      const int q = it >> c, i = it & ((1 << c) - 1), bit = q * CB + c;
      if (bit < k) {
        uint32_t* row = chunk + q * S::CW * FQ_WORDS;
        hc_load(x, xi + (k - 1 - bit) * FQ_WORDS);
        if (i == 0 && q != 0 && q != 2) {
          hc_store(row + (1 << c) * FQ_WORDS, x);
        } else {
          hc_load(y, row + i * FQ_WORDS);
          fe_mul<FR>(r, y, x);
          hc_store(row + ((1 << c) + i) * FQ_WORDS, r);
        }
      }
    }
    __syncthreads();
  }
  // T[lo] = chunk 0's entry for lo's low CB bits times chunk 1's for its
  // high ones: s P_lo, Montgomery form.
#pragma unroll 1
  for (int lo = tid; lo < n_lo; lo += THREADS) {
    const int hi = lo >> CB;
    hc_load(x, chunk + (lo & (S::CW - 1)) * FQ_WORDS);
    if (hi) {
      hc_load(y, chunk + (S::CW + hi) * FQ_WORDS);
      fe_mul<FR>(r, x, y);
      hc_store(table + lo * FQ_WORDS, r);
    } else {
      hc_store(table + lo * FQ_WORDS, x);
    }
  }
  __syncthreads();
}

// F: the plain product of tile t's challenges (its index's chunks 2, 3, ...).
template <int CB>
__device__ __forceinline__ void hc_factor(uint32_t f[FQ_WORDS], const uint32_t* chunk,
                                          long long t) {
  using S = HcShape<CB>;
  uint32_t y[FQ_WORDS], r[FQ_WORDS];
  hc_load(f, chunk + (2 * S::CW + (int)(t & (S::CW - 1))) * FQ_WORDS);
#pragma unroll 1
  for (int q = 3; q < S::NCHUNK; q++) {
    const int v = (int)((t >> ((q - 2) * CB)) & (S::CW - 1));
    if (v) {
      hc_load(y, chunk + (q * S::CW + v) * FQ_WORDS);
      fe_mul<FR>(r, f, y);
      fe_copy(f, r);
    }
  }
}

// xi (k, 8) Fr Montgomery words, s (8,) the Montgomery factor; out (2^k,
// 16) int64.  THREADS threads a block, hc_smem_bytes<THREADS, CB>() of
// dynamic shared memory; the host launches at most as many blocks as tiles.
template <int THREADS, int CB>
__global__ void __launch_bounds__(THREADS)
    ipa_h_coeffs_kernel(const uint32_t* __restrict__ xi, const uint32_t* __restrict__ s, int k,
                        long long* __restrict__ out) {
  using S = HcShape<CB>;
  extern __shared__ uint4 hc_smem[];
  uint32_t* chunk = reinterpret_cast<uint32_t*>(hc_smem);  // (NCHUNK, CW, 8)
  uint32_t* table = chunk + S::CHUNK_WORDS;                // (2^tb, 8)
  long long* stage = reinterpret_cast<long long*>(table + S::TILE_WORDS);  // (2, THREADS, 16)
  const int tid = threadIdx.x;
  const int tb = k < S::TB ? k : S::TB;
  const int n_lo = 1 << tb;
  const int sub = n_lo < THREADS ? n_lo : THREADS;  // coefficients a bulk copy
  const long long tiles = 1ll << (k - tb);
  uint32_t x[FQ_WORDS], r[FQ_WORDS], f[FQ_WORDS];
  hc_tables<THREADS, CB>(xi, s, k, chunk, table);

  int buf = 0;
#pragma unroll 1
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    hc_factor<CB>(f, chunk, t);
#pragma unroll 1
    for (int l0 = 0; l0 < n_lo; l0 += sub, buf ^= 1) {
      long long* st = stage + buf * THREADS * 2 * FQ_WORDS;
      if (tid < sub) {
        hc_load(x, table + (l0 + tid) * FQ_WORDS);
        fe_mul<FR>(r, x, f);  // s P_lo R * P_hi / R: the plain coefficient
        fe_canon<FR>(x, r);
        longlong2* row = reinterpret_cast<longlong2*>(st + tid * 2 * FQ_WORDS);
#pragma unroll
        for (int i = 0; i < FQ_WORDS; i++) {  // word w is limbs 2w and 2w + 1
          const int w = (i + tid) & (FQ_WORDS - 1);
          row[w] = make_longlong2(x[w] & 0xffffu, x[w] >> 16);
        }
        bulk_fence_shared();
      }
      if (tid == 0) bulk_wait_read();  // the other buffer's copy has read it
      __syncthreads();
      if (tid == 0) bulk_store(out + ((t << tb) + l0) * (2 * FQ_WORDS), st, sub * 128);
    }
  }
  if (tid == 0) bulk_wait();
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  xi (k, 8) and s (8,) Fr Montgomery
// words, out (2^k, 16) int64 canonical 16-bit limbs, 0 <= k <= 30.
extern "C" int svt_ipa_h_coeffs(const void* xi, int k, const void* s, void* out, void* stream) {
  if (k < 0 || k > svt::HC_MAX_K) return (int)cudaErrorInvalidValue;
  constexpr int bytes = svt::hc_smem_bytes<svt::HC_THREADS, svt::HC_CHUNK_BITS>();
  const auto kernel = svt::ipa_h_coeffs_kernel<svt::HC_THREADS, svt::HC_CHUNK_BITS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tb = svt::HcShape<svt::HC_CHUNK_BITS>::TB;
  const long long tiles = 1ll << (k < tb ? 0 : k - tb);
  const long long most = (long long)sms * svt::HC_BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(tiles < most ? tiles : most);
  kernel<<<blocks, svt::HC_THREADS, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)xi, (const uint32_t*)s, k, (long long*)out);
  return (int)cudaGetLastError();
}
