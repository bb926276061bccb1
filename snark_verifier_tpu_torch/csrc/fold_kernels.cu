// Dense bucket folds and the add-chain probe for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes, see _build.py and
// msm/cuda_ops.py).  Points are 32-bit words in the kernels' layout
// ((..., 3, 8): Fq in Montgomery form, homogeneous projective).
//
// * svt_fold_segments replaces the three Pallas kernels that fold a DENSE
//   (NB, w, 105) RNS bucket matrix of points (msm/pallas_ops.py):
//   _pallas_fold_level (K adjacent slots per output, :246),
//   _pallas_fold_halving (`layers` halving layers across the width, :326)
//   and _pallas_fold_grid (the same halving inside each wb-wide chunk,
//   3-D blocks, :589).  All three are one function,
//       out[b, j] = sum_{k < count} mat[b, (j / G) * CW + (j % G) + k * S],
//   with (G, CW, S, count) = (1, K, 1, K) for a level, (g, w, g, 2^layers)
//   for halving (g = w >> layers) and (g', wb, g', 2^layers) for the grid
//   (g' = wb >> layers).  Each output slot sums exactly the slot subset of
//   its Pallas kernel.  The Pallas walks pad each width with identity
//   rows; here a member at or past the matrix's real width w is that
//   identity: it is skipped (no load, no add), and nothing is padded.
// * svt_g1_add_chain and svt_fq_mul_chain replace the probe
//   benchmarks/micro_packed_dissect.py (:48): a chain of CH dependent RC15
//   adds a <- a + b (or Fq multiplies a <- a*b, or squares a <- a^2 when no
//   b is given) on register-resident data.
//   The TPU probe stubbed parts of its RNS multiply; these are exact, and
//   their time is the pure arithmetic rate of one thread's add or multiply
//   with no memory traffic.
//
// Bounds on an H100 SXM (16.7e12 32-bit multiply-adds/s, 3.35 TB/s): a fold
// add is 1632 multiply-adds against one 96-byte point read, so the fold is
// multiply-bound (a full fold of (256, 4624) points: 0.116 ms of multiplies
// against 0.034 ms of reads).  The 64-bit products of fq.cuh run at half
// that rate (msm_kernels.cu), so half the bound is the most a fold reaches.
// The chains read and write 2 * 96 bytes per lane once and do CH * 1632 (or
// CH * 136) multiply-adds: bound by operations at any CH > 1.
//
// What the fold's design does about it.  A lone warp waits ~950 clocks on
// each multiply; the multiply pipes are busy only with about seven warps of
// independent chains on every SM.  The first level of a dense fold has
// slots enough for that; the levels after it do not (a K = 8 walk's later
// levels have 18,688, 2,560, 512 and 256 slots for ~50,000 resident
// threads), and there one thread per slot costs its chain's latency,
// count - 1 dependent adds.  So a slot gets a team of T lanes (1 to 32,
// inside one warp): lane t sums the slot's members t, t + T, ... in
// registers, asking for its next member before it adds the current one,
// and the team combines its partial sums in log2 T rounds of
// __shfl_xor_sync and g1_add -- no shared memory, no barrier -- so a slot
// costs ceil(count / T) - 1 + log2 T dependent adds.  The wrapper picks T
// from the slots, the real members and the SM count
// (cuda_ops.segment_team): T = 1 where the slots fill the card.  A lane
// with no real member holds nothing; a combine round adds only where both
// partners hold a sum.  With S = 1 a team's lanes read adjacent 96-byte
// rows, six 16-byte loads each.  On an NVIDIA H100 80GB HBM3 at 700 W
// (kernel_compare.py against the one-thread-a-slot kernel whose walks
// padded): the three dense walks of a (256, 4624) matrix take 0.35-0.39 ms
// (0.55-0.90 before), their later levels 2-7x less, the grid walk's first
// level, no longer padded, 0.29 ms (0.49); 32-thread blocks measured the
// same as 128.  What is left: a walk's first level, 70-76% of its time,
// runs at about 80% of the multiply's half rate, and its count-16 form ends
// on a partial round of 15-add chains; each later level is one launch at
// its chain's latency plus a few us of launch and first loads (a walk's
// levels are not fused); one thread carries a whole 256-bit product.

#include <cuda_runtime.h>

#include <cstdint>

#include "g1.cuh"

namespace svt {

constexpr int SEG_BLOCK = 128;
// Resident blocks per SM the register bound allows for (<= 168 registers).
constexpr int SEG_BLOCKS_PER_SM = 3;
constexpr int CHAIN_THREADS = 128;

// One output slot per team of `team` lanes (a power of two <= 32, so a team
// lies inside one warp).  A slot's members are first + k * S, k < count;
// those at or past w are identities and are skipped.  A thread past the
// last slot has no member but still takes part in the team's shuffles.
__global__ void __launch_bounds__(SEG_BLOCK, SEG_BLOCKS_PER_SM)
    fold_segments_kernel(const uint32_t* __restrict__ mat, long long w, long long wout,
                         long long n_out, long long G, long long CW, long long S, int count,
                         int team, uint32_t* __restrict__ out) {
  const long long slot = ((long long)blockIdx.x * SEG_BLOCK + threadIdx.x) / team;
  const int t = threadIdx.x & (team - 1);
  const bool valid = slot < n_out;
  const long long b = valid ? slot / wout : 0, j = valid ? slot % wout : 0;
  const long long first = (j / G) * CW + (j % G);
  // members k < n_real lie inside the matrix (first + k * S < w)
  const int n_real = valid && first < w ? (int)min((long long)count, (w - first + S - 1) / S) : 0;
  const uint32_t* base = mat + (b * w + first) * G1_WORDS;
  const long long step = S * G1_WORDS;
  bool has = t < n_real;
  G1 acc, cur;
  if (has) g1_load_nc(acc, base + t * step);
  else g1_identity(acc);
  int k = t + team;
  if (k < n_real) g1_load_nc(cur, base + k * step);
#pragma unroll 1
  for (; k < n_real; k += team) {
    // the next member, or this one again on the last step (no branch)
    const int kn = k + team < n_real ? k + team : k;
    G1 nxt;
    g1_load_nc(nxt, base + kn * step);
    g1_add(acc, acc, cur);
    cur = nxt;
  }
#pragma unroll 1
  for (int m = team >> 1; m > 0; m >>= 1) {
    G1 q;
    g1_shfl_xor(q, acc, m);
    const bool qhas = __shfl_xor_sync(0xffffffffu, (int)has, m) != 0;
    if (has && qhas) {
      g1_add(acc, acc, q);
    } else if (qhas) {
      acc = q;
    }
    has = has || qhas;
  }
  if (t == 0 && valid) g1_store(out + slot * G1_WORDS, acc);
}

__global__ void __launch_bounds__(CHAIN_THREADS)
    g1_add_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, long long n, int ch) {
  const long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= n) return;
  G1 p, q;
  g1_load(p, a + i * G1_WORDS);
  g1_load(q, b + i * G1_WORDS);
#pragma unroll 1
  for (int k = 0; k < ch; k++) g1_add(p, p, q);
  g1_store(out + i * G1_WORDS, p);
}

// SQUARE: ch steps of x <- x^2 through fe_sqr (b is not read); else ch steps
// of x <- x*b through fe_mul.
template <bool SQUARE>
__global__ void __launch_bounds__(CHAIN_THREADS)
    fq_mul_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, long long n, int ch) {
  const long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], y[FQ_WORDS];
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) {
    x[k] = a[i * FQ_WORDS + k];
    y[k] = SQUARE ? 0u : b[i * FQ_WORDS + k];
  }
#pragma unroll 1
  for (int k = 0; k < ch; k++) {
    if constexpr (SQUARE) {
      fe_sqr<FQ>(x, x);
    } else {
      fq_mul(x, x, y);
    }
  }
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) out[i * FQ_WORDS + k] = x[k];
}

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).  The wrappers check that
// every slot index a launch reads lies inside the matrix.

// w: the matrix's real width (its row stride); members at or past it are
// skipped.  team: lanes per output slot, 1, 2, 4, 8, 16 or 32.
extern "C" int svt_fold_segments(const void* mat, long long nb, long long w, long long wout,
                                 long long G, long long CW, long long S, int count, int team,
                                 void* out, void* stream) {
  if (team < 1 || team > 32 || (team & (team - 1))) return (int)cudaErrorInvalidValue;
  const long long n_out = nb * wout;
  if (n_out > 0) {
    const long long threads = n_out * team;
    const long long blocks = (threads + svt::SEG_BLOCK - 1) / svt::SEG_BLOCK;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    svt::fold_segments_kernel<<<(unsigned)blocks, svt::SEG_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)mat, w, wout, n_out, G, CW, S, count, team, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_g1_add_chain(const void* a, const void* b, void* out, long long n, int ch,
                                void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::CHAIN_THREADS - 1) / svt::CHAIN_THREADS);
    svt::g1_add_chain_kernel<<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, ch);
  }
  return (int)cudaGetLastError();
}

extern "C" int svt_fq_mul_chain(const void* a, const void* b, void* out, long long n, int ch,
                                void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + svt::CHAIN_THREADS - 1) / svt::CHAIN_THREADS);
    if (b == nullptr)  // the squaring chain
      svt::fq_mul_chain_kernel<true><<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, nullptr, (uint32_t*)out, n, ch);
    else
      svt::fq_mul_chain_kernel<false><<<blocks, svt::CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, ch);
  }
  return (int)cudaGetLastError();
}
