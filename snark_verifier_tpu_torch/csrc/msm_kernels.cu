// The port's MSM kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes, see _build.py and msm/cuda_ops.py).  Points are
// (B, 3, 8) 32-bit words: Fq in Montgomery form, homogeneous projective.
//
// Three kernels, each the counterpart of a Pallas kernel of the JAX package:
//
// * svt_g1_add    replaces msm/pallas_ops.py::add (_binop_kernel ->
//                 _rc15_add_2d): the RC15 complete add of two point batches.
// * svt_g1_double replaces msm/pallas_ops.py::double (_unop_kernel ->
//                 _rc15_double_2d): the RC15 complete doubling.
//                 Both write canonical words: the same projective triple
//                 as the plain version's lazy words after canon, in [0, p)
//                 -- lazy input to any caller (msm_sharded._tree_fold).
// * svt_fold_buckets replaces msm/pippenger.py::_fold_buckets_pallas: the
//                 XLA gather of the slot-index matrix plus the Pallas bucket
//                 fold (pallas_ops.py::fold_buckets_grid_pk and
//                 ::fold_buckets_grid).  The gather is fused: the kernel reads
//                 point rows by index, so the (buckets, capacity) matrix of
//                 points is never written to device memory (249 MB per window
//                 on the JAX path at 2^20).
//
// What bounds them on an H100 SXM: the integer multiply throughput, 64
// 32-bit multiply-adds per SM per clock, 132 SMs at 1.98 GHz = 16.7e12/s,
// and 3.35 TB/s.  The batch add's least work is 6 products and 3 sums of
// two products sharing a reduction (fq.cuh's fe_mul_sum): 6 * 136 + 3 *
// 200 = 1416 multiply-adds, 84.8 ps of the card, against its bytes, two
// 96-byte points in and one out = 288 B = 86.0 ps: on the ridge, by a
// hair on the bytes' side.  The batch double: 4 products, 2 squares (36
// products, 8 digits and 64 m*p: 108 multiply-adds each) and one sum =
// 544 + 216 + 200 = 960 multiply-adds, 57.5 ps, against 192 B = 57.3 ps.
// The fold (g1.cuh's g1_add: 12 * 136 = 1632 a point, reading one 96-byte
// point and a 4-byte index) is multiply-bound three times over.  Integer
// Montgomery arithmetic has no tensor-core path (wgmma takes floating point
// and int8 tiles), and its 64-bit products run at half that rate (fq.cuh),
// so half of the bound is the most this multiply can reach.
//
// What the batch kernels' design does about it (g1_batch_kernel).  A
// thread's add is one long chain of dependent carry chains, so the time is
// set by how many warps an SM holds (residency), then by the multiplies:
// * persistent blocks: 128 threads, a point a thread, walk tiles of 128
//   points with a stride of the grid, min(tiles, BLOCKS an SM), BLOCKS the
//   launch bound's: the add 4 (126 registers, no spills), the double 5
//   (95): four and five warps a scheduler whatever the batch, where one
//   block of 256 threads an SM (above 128 registers) held two;
// * layer 2 of the add ends in three sums of two products (X3 = t3 t1m +
//   t4 (-yb), Y3 = t1m z3l + yb t0_3, Z3 = z3l t4 + t0_3 t3) and the
//   double's Y3 = t0m y3l + t2 z8 in one: fe_mul_sum, one reduction a sum
//   (1632 -> 1416 multiply-adds an add, 1088 -> 1016 a double, 960 with
//   the squares' 36 products).  Its result lies below
//   2.52p, so every coordinate goes through fe_canon before the store (the
//   lazy [0, 2p] words of g1.cuh need no such step, and the output
//   contract became canonical words for both kernels);
// * the double's tiles arrive by TMA: a tile's rows are contiguous (128 *
//   96 B), and one thread copies them into a ring of two stages in shared
//   memory with 1-D bulk loads (bulk.cuh), completed on an mbarrier a
//   stage; the next load into a stage is issued as soon as its tile is in
//   registers, so the loads of a block's next two tiles overlap its own
//   multiplies, and the results leave, staged in shared memory, as one
//   bulk store a tile.  The rows stay [point][word] as they land: a 16-byte
//   read of a 96-byte row costs a 2-way bank conflict, six times a point,
//   beside ~1,000 wide multiplies.  The add loads and stores its rows
//   directly (16 bytes a thread): its ring and staging (61 KB a block at
//   two stages, 37 KB at one) measured 1% slower at 4 blocks, where only
//   one stage fits.
// The template keeps every variant (separate reductions: g1.cuh's formulas
// then fe_canon; bulk or direct copies; 3 to 6 blocks an SM); the library
// instantiates the one that measured fastest for each operation (NVIDIA
// H100 80GB HBM3, 700 W, kernel_compare.py --only g1_batch at 2^19: the add
// 0.157 -> 0.117 ms, the double 0.081 -> 0.078 ms), and
// csrc/probe/g1_batch_variants.cu builds the others from this file.
//
// What the fold's design does about it.  Its time is the latency of each
// thread's chain of dependent adds unless enough independent chains are
// resident to fill the multiply pipes, so the design is about residency:
// * rows fill the card, not threads within a row.  The MSM folds all its
//   main windows in one launch (7,936 rows at 2^20), one warp per row: each
//   lane sums its strided slots in registers and the warp reduces with five
//   rounds of shuffles -- no shared memory, no block barrier, and other
//   rows' warps on the SM fill the lanes the tree leaves idle.  A launch
//   with few rows (the top window's segments, a lone window) gives a row a
//   team of 64 or 128 threads instead (their warps' sums meet in shared
//   memory), so that it still fills the card; the host picks the largest
//   team whose blocks are all resident at once (cuda_ops._fold_team);
// * blocks of 128 threads bounded to three per SM: 168 registers, no
//   spills, three warps per scheduler.  Four per SM cost 128 registers and
//   60-76 bytes of spills and measured 2-10% slower; two were no faster;
// * each lane reads its index two slots ahead and asks for its next point
//   before it adds the current one, so the gather's latency hides behind
//   the add.
// All main windows of the 2^20 MSM fold in 8.1 ms, 2.6x their bound and
// about 80% of the rate the multiply itself reaches (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py).  What is left on the table: points
// in array-of-structures rows (96-byte stride, six 16-byte loads per lane);
// one thread still carries a whole 256-bit product.  The add and double
// kernels stay as the counterparts of the two Pallas kernels; of the main
// paths only the sharded MSM's fold of its partial sums launches the add.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "g1.cuh"

namespace svt {

constexpr int FOLD_BLOCK = 128;
// Resident fold blocks per SM that the register bound allows for; the
// wrapper's choice of team (cuda_ops._fold_team) counts on the same number.
constexpr int FOLD_BLOCKS_PER_SM = 3;

// ---- the batch add and double ------------------------------------------

constexpr int G1B_THREADS = 128;  // a tile: a point a thread
constexpr int G1B_TILE_WORDS = G1B_THREADS * G1_WORDS;
constexpr int G1B_TILE_BYTES = G1B_TILE_WORDS * 4;
constexpr int SM_SMEM_BYTES = 233472;  // an H100 SM's shared memory, 1 KB a block reserved

// The library's variant of each operation (IN inputs): one reduction a sum
// of two products; the add with direct copies at 4 blocks an SM, the
// double with bulk copies at 5.
constexpr bool G1B_SUM = true;
template <int IN>
constexpr bool g1b_bulk() {
  return IN == 1;
}
template <int IN>
constexpr int g1b_blocks() {
  return IN == 2 ? 4 : 5;
}

// Dynamic shared memory of a bulk-copy block with IN input batches and a
// ring of STAGES tiles of each: the stages' mbarriers (16 bytes), the ring
// and the staged results (one tile).
template <int IN, int STAGES>
__host__ __device__ constexpr int g1b_smem_bytes() {
  return 16 + (STAGES * IN + 1) * G1B_TILE_BYTES;
}

// Tiles of loads a bulk-copy block keeps in flight: two where BLOCKS blocks
// an SM still fit its shared memory, else one (the add at 4 blocks or more).
template <int IN, int BLOCKS>
__host__ __device__ constexpr int g1b_stages() {
  return SM_SMEM_BYTES / BLOCKS - 1024 >= g1b_smem_bytes<IN, 2>() ? 2 : 1;
}

// out[i] = a[i] + b[i] (IN = 2) or 2 a[i] (IN = 1), canonical words, for
// i < n.  SUM: g1.cuh's g1_add_sum / g1_double_sum, else its g1_add /
// g1_double then fe_canon.  BULK: tiles through the shared-memory ring and
// the staged store, else each thread loads and stores its own row.  Blocks
// walk tiles t = blockIdx.x, + gridDim.x, ...; every block has a tile.
template <int IN, bool SUM, bool BULK, int BLOCKS>
__global__ void __launch_bounds__(G1B_THREADS, BLOCKS)
    g1_batch_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n) {
  const int tid = threadIdx.x;
  const long long tiles = (n + G1B_THREADS - 1) / G1B_THREADS;
  auto op = [](G1& p, const G1& q) {
    if constexpr (IN == 2) {
      if constexpr (SUM) {
        g1_add_sum(p, p, q);
      } else {
        g1_add(p, p, q);
        g1_canon(p);
      }
    } else if constexpr (SUM) {
      g1_double_sum(p, p);
    } else {
      g1_double(p, p);
      g1_canon(p);
    }
  };
  if constexpr (!BULK) {
#pragma unroll 1
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long i = t * G1B_THREADS + tid;
      if (i >= n) continue;
      G1 p, q;
      g1_load_nc(p, a + i * G1_WORDS);
      if constexpr (IN == 2) g1_load_nc(q, b + i * G1_WORDS);
      op(p, q);
      g1_store(out + i * G1_WORDS, p);
    }
  } else {
    extern __shared__ uint4 g1b_smem[];
    constexpr int STAGES = g1b_stages<IN, BLOCKS>();
    uint64_t* bar = reinterpret_cast<uint64_t*>(g1b_smem);       // (STAGES,)
    uint32_t* ring = reinterpret_cast<uint32_t*>(g1b_smem + 1);  // (STAGES, IN, tile)
    uint32_t* staged = ring + STAGES * IN * G1B_TILE_WORDS;      // (tile)
    const uint32_t* src[2] = {a, b};
    // Thread 0: tile t's rows of every input into stage s.
    auto issue = [&](long long t, int s) {
      const long long first = t * G1B_THREADS;
      const long long rows = n - first < G1B_THREADS ? n - first : G1B_THREADS;
      const uint32_t bytes = (uint32_t)(rows * G1_WORDS * 4);
      bulk_expect(bar + s, IN * bytes);
#pragma unroll
      for (int k = 0; k < IN; k++)
        bulk_load(ring + (s * IN + k) * G1B_TILE_WORDS, src[k] + first * G1_WORDS, bytes,
                  bar + s);
    };
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; s++) bulk_barrier_init(bar + s);
      bulk_fence_init();
#pragma unroll
      for (int s = 0; s < STAGES; s++) {
        const long long t = blockIdx.x + (long long)s * gridDim.x;
        if (t < tiles) issue(t, s);
      }
    }
    __syncthreads();
    int j = 0;  // this block's tiles so far: stage j % STAGES, phase j / STAGES
#pragma unroll 1
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x, j++) {
      const int s = j % STAGES;
      const long long first = t * G1B_THREADS;
      const long long rows = n - first < G1B_THREADS ? n - first : G1B_THREADS;
      bulk_wait_phase(bar + s, (uint32_t)(j / STAGES) & 1u);
      G1 p, q;
      if (tid < rows) {
        g1_load(p, ring + (s * IN * G1B_THREADS + tid) * G1_WORDS);
        if constexpr (IN == 2) g1_load(q, ring + ((s * IN + 1) * G1B_THREADS + tid) * G1_WORDS);
      }
      if (tid == 0) bulk_wait_read();  // the last tile's store has read `staged`
      __syncthreads();                 // stage s and `staged` are free
      if (tid == 0) {
        const long long next = t + (long long)STAGES * gridDim.x;
        if (next < tiles) issue(next, s);
      }
      if (tid < rows) {
        op(p, q);
        g1_store(staged + tid * G1_WORDS, p);
        bulk_fence_shared();
      }
      __syncthreads();
      if (tid == 0) bulk_store(out + first * G1_WORDS, staged, (uint32_t)(rows * G1_WORDS * 4));
    }
    if (tid == 0) bulk_wait();
  }
}

// Launch the batch kernel variant over n points: min(tiles, SMs x BLOCKS)
// blocks on `st`; returns a cudaError_t.
template <int IN, bool SUM, bool BULK, int BLOCKS = g1b_blocks<IN>()>
int launch_g1_batch(const void* a, const void* b, void* out, long long n, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto kernel = g1_batch_kernel<IN, SUM, BULK, BLOCKS>;
  const int bytes = BULK ? g1b_smem_bytes<IN, g1b_stages<IN, BLOCKS>()>() : 0;
  cudaError_t err;
  if (BULK && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          bytes)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (n + G1B_THREADS - 1) / G1B_THREADS;
  const long long most = (long long)sms * BLOCKS;
  const unsigned blocks = (unsigned)(tiles < most ? tiles : most);
  kernel<<<blocks, G1B_THREADS, bytes, st>>>((const uint32_t*)a, (const uint32_t*)b,
                                              (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// Bucket sums of idx (nb, cap): a team of TEAM threads per row, FOLD_BLOCK /
// TEAM rows per block.  Thread t of a team sums slots t, t + TEAM, ... of its
// row into a register accumulator; entries equal to `sentinel` (the index of
// the identity row, n) -- or outside [0, sentinel) -- are the identity and
// are skipped.  The team's partial sums are reduced by shuffles inside each
// warp and, for a team of several warps, once more through shared memory.
// Summation order differs from the plain version's halving fold, so the
// projective outputs differ; the points are equal.
template <int TEAM>
__global__ void __launch_bounds__(FOLD_BLOCK, FOLD_BLOCKS_PER_SM)
    fold_buckets_kernel(const uint32_t* __restrict__ points, const int32_t* __restrict__ idx,
                        long long nb, long long cap, int sentinel, uint32_t* __restrict__ out) {
  static_assert(TEAM % 32 == 0 && FOLD_BLOCK % TEAM == 0, "a team is whole warps of one block");
  const int t = threadIdx.x % TEAM;
  const long long r = (long long)blockIdx.x * (FOLD_BLOCK / TEAM) + threadIdx.x / TEAM;
  // A team past the last row repeats it and stores nothing: every thread of
  // the block reaches the barrier below.
  const int32_t* row = idx + (r < nb ? r : nb - 1) * cap;
  G1 acc, cur;
  g1_identity(acc);
  int k0 = t < cap ? __ldg(row + t) : sentinel;
  int k1 = t + TEAM < cap ? __ldg(row + t + TEAM) : sentinel;
  bool live = (unsigned)k0 < (unsigned)sentinel;
  // Row `sentinel` of points is the identity: an empty slot loads it and
  // skips the add.
  g1_load_nc(cur, points + (long long)(live ? k0 : sentinel) * G1_WORDS);
#pragma unroll 1
  for (long long j = t; j < cap; j += TEAM) {
    const int k2 = j + 2 * TEAM < cap ? __ldg(row + j + 2 * TEAM) : sentinel;
    const bool live1 = (unsigned)k1 < (unsigned)sentinel;
    G1 nxt;
    g1_load_nc(nxt, points + (long long)(live1 ? k1 : sentinel) * G1_WORDS);
    if (live) g1_add(acc, acc, cur);
    cur = nxt;
    live = live1;
    k1 = k2;
  }
#pragma unroll 1
  for (int s = 16; s > 0; s >>= 1) {
    G1 q;
    g1_shfl_xor(q, acc, s);
    g1_add(acc, acc, q);
  }
  if constexpr (TEAM > 32) {
    constexpr int WARPS = TEAM / 32;
    __shared__ uint4 part[(FOLD_BLOCK / 32) * (G1_WORDS / 4)];
    // this team's WARPS slots of the block's array
    uint32_t* words = reinterpret_cast<uint32_t*>(part) + (threadIdx.x / TEAM) * WARPS * G1_WORDS;
    if (t % 32 == 0) g1_store(words + (t / 32) * G1_WORDS, acc);
    __syncthreads();
    if (t >= 32) return;
    // Lanes 0 .. WARPS-1 of warp 0 take one warp's sum each; the lanes
    // above them repeat lane 0's and their results are not used.
    g1_load(acc, words + (t < WARPS ? t : 0) * G1_WORDS);
#pragma unroll 1
    for (int s = WARPS / 2; s > 0; s >>= 1) {
      G1 q;
      g1_shfl_xor(q, acc, s);
      g1_add(acc, acc, q);
    }
  }
  if (t == 0 && r < nb) g1_store(out + r * G1_WORDS, acc);
}

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

// a, b, out: (n, 3, 8) words, 16-byte aligned, out apart from the inputs.
extern "C" int svt_g1_add(const void* a, const void* b, void* out, long long n, void* stream) {
  return svt::launch_g1_batch<2, svt::G1B_SUM, svt::g1b_bulk<2>()>(a, b, out, n,
                                                                    (cudaStream_t)stream);
}

extern "C" int svt_g1_double(const void* a, void* out, long long n, void* stream) {
  return svt::launch_g1_batch<1, svt::G1B_SUM, svt::g1b_bulk<1>()>(a, nullptr, out, n,
                                                                    (cudaStream_t)stream);
}

// team: threads per bucket row, 32, 64 or 128 (the wrapper picks it from nb).
extern "C" int svt_fold_buckets(const void* points, const void* idx, long long nb, long long cap,
                                int sentinel, void* out, int team, void* stream) {
  if (team != 32 && team != 64 && team != svt::FOLD_BLOCK) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const auto st = (cudaStream_t)stream;
    const long long rows_per_block = svt::FOLD_BLOCK / team;
    const unsigned blocks = (unsigned)((nb + rows_per_block - 1) / rows_per_block);
    const auto* pts = (const uint32_t*)points;
    const auto* ix = (const int32_t*)idx;
    auto* o = (uint32_t*)out;
    if (team == 32)
      svt::fold_buckets_kernel<32><<<blocks, svt::FOLD_BLOCK, 0, st>>>(pts, ix, nb, cap, sentinel, o);
    else if (team == 64)
      svt::fold_buckets_kernel<64><<<blocks, svt::FOLD_BLOCK, 0, st>>>(pts, ix, nb, cap, sentinel, o);
    else
      svt::fold_buckets_kernel<svt::FOLD_BLOCK><<<blocks, svt::FOLD_BLOCK, 0, st>>>(
          pts, ix, nb, cap, sentinel, o);
  }
  return (int)cudaGetLastError();
}
