// The point loops of ../msm_loops.cuh in the variants the library does not
// keep, for kernel_compare.py to time beside it in one process:
//
// * svt_bucket_reduce at every team size (the library keeps RED_T);
// * both kernels with the layers' products exchanged by warp shuffles
//   instead of the team's slots in shared memory (g1_team.cuh keeps the
//   one that measured faster).
//
// Not part of the library; built on its own:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//        -o libpoint_loop_variants.so point_loop_variants.cu

#include "../msm_loops.cuh"

namespace svt {

// Every lane reads product j from lane first + j % T's v[j / T]: NP * 8
// shuffles a layer, no barrier (a shuffle synchronises its lanes).
struct G1ShuffleExchange {
  int first;
  __device__ G1ShuffleExchange(G1TeamSlots&, int first_lane) : first(first_lane) {}
  template <int T, int NP>
  __device__ __forceinline__ void exchange(uint32_t (*P)[FQ_WORDS],
                                           uint32_t (*v)[FQ_WORDS], int) const {
#pragma unroll
    for (int j = 0; j < NP; j++)
#pragma unroll
      for (int w = 0; w < FQ_WORDS; w++)
        P[j][w] = __shfl_sync(0xffffffffu, v[j / T][w], first + j % T);
  }
};

template <int T, class X>
int launch_bucket_reduce(const void* buckets, void* part, void* out, cudaStream_t st) {
  auto* ticket = (unsigned*)((uint32_t*)part + RED_WINDOWS * G1_WORDS);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  bucket_reduce_kernel<T, X><<<RED_WINDOWS, red_warps<T>() * 32, 0, st>>>(
      (const uint32_t*)buckets, (uint32_t*)part, ticket, (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <class X>
int bucket_reduce_team(const void* buckets, void* part, void* out, int team, cudaStream_t st) {
  switch (team) {
    case 1: return launch_bucket_reduce<1, X>(buckets, part, out, st);
    case 2: return launch_bucket_reduce<2, X>(buckets, part, out, st);
    case 4: return launch_bucket_reduce<4, X>(buckets, part, out, st);
    case 6: return launch_bucket_reduce<6, X>(buckets, part, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace svt

// svt_bucket_reduce's arguments, the team size and the exchange (0: the
// team's slots, 1: shuffles).
extern "C" int svt_bucket_reduce_variant(const void* buckets, void* part, void* out, int team,
                                         int shuffle, void* stream) {
  const auto st = (cudaStream_t)stream;
  return shuffle ? svt::bucket_reduce_team<svt::G1ShuffleExchange>(buckets, part, out, team, st)
                 : svt::bucket_reduce_team<svt::G1SharedExchange>(buckets, part, out, team, st);
}

// svt_msm_windowed with the products exchanged by shuffles.
extern "C" int svt_msm_windowed_shuffle(const void* pts, const void* scalars, long long nproofs,
                                        int n, int team, int per_block, void* out, void* stream) {
  if (nproofs <= 0 || n < 0) return (int)cudaGetLastError();
  const auto st = (cudaStream_t)stream;
  using X = svt::G1ShuffleExchange;
  switch (team) {
    case 6: return svt::launch_msm_windowed<6, X>(pts, scalars, nproofs, n, per_block, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
