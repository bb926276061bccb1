// The other store route for svt_ipa_h_coeffs (csrc/ipa_kernels.cu): each
// tile's 1,024 canonical coefficients staged in shared memory as 8 uint32
// words each (four a thread, into one of two buffers), a barrier, then
// stored by the threads themselves: thread t expands words t, t + 256, ...
// into two int64 limbs each, one 16-byte store apiece, so a warp's store
// covers 512 contiguous bytes.  The same tables (hc_tables, hc_factor) and
// the same output, word for word.  Measured 8% slower than the library's
// TMA bulk copies at k = 20 (kernel_compare.py), so it is not in the
// library.  Standalone (the library builds csrc/*.cu only):
// kernel_compare.py builds it with nvcc as its own library and times its
// entry point `svt_ipa_h_coeffs_vec(xi, k, s, out, stream)` beside the
// library's `svt_ipa_h_coeffs`.
#include "../ipa_kernels.cu"

namespace svt {

template <int CB>
constexpr int hv_smem_bytes() {
  return HcShape<CB>::TABLE_BYTES + 2 * 4 * HcShape<CB>::TILE_WORDS;
}

template <int THREADS, int CB>
__global__ void __launch_bounds__(THREADS)
    ipa_h_coeffs_vec_kernel(const uint32_t* __restrict__ xi, const uint32_t* __restrict__ s,
                            int k, long long* __restrict__ out) {
  using S = HcShape<CB>;
  extern __shared__ uint4 hc_smem[];
  uint32_t* chunk = reinterpret_cast<uint32_t*>(hc_smem);
  uint32_t* table = chunk + S::CHUNK_WORDS;
  uint32_t* stage = table + S::TILE_WORDS;  // (2, 2^tb, 8)
  const int tid = threadIdx.x;
  const int tb = k < S::TB ? k : S::TB;
  const int n_lo = 1 << tb;
  const long long tiles = 1ll << (k - tb);
  uint32_t x[FQ_WORDS], r[FQ_WORDS], f[FQ_WORDS];
  hc_tables<THREADS, CB>(xi, s, k, chunk, table);

  int buf = 0;
#pragma unroll 1
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {
    hc_factor<CB>(f, chunk, t);
    uint32_t* st = stage + buf * S::TILE_WORDS;
#pragma unroll 1
    for (int lo = tid; lo < n_lo; lo += THREADS) {
      hc_load(x, table + lo * FQ_WORDS);
      fe_mul<FR>(r, x, f);
      fe_canon<FR>(x, r);
      hc_store(st + lo * FQ_WORDS, x);
    }
    __syncthreads();
    longlong2* dst = reinterpret_cast<longlong2*>(out + (t << tb) * (2 * FQ_WORDS));
#pragma unroll 4
    for (int w = tid; w < n_lo * FQ_WORDS; w += THREADS) {
      const uint32_t v = st[w];
      dst[w] = make_longlong2(v & 0xffffu, v >> 16);
    }
  }
}

}  // namespace svt

extern "C" int svt_ipa_h_coeffs_vec(const void* xi, int k, const void* s, void* out,
                                    void* stream) {
  if (k < 0 || k > svt::HC_MAX_K) return (int)cudaErrorInvalidValue;
  constexpr int bytes = svt::hv_smem_bytes<svt::HC_CHUNK_BITS>();
  const auto kernel = svt::ipa_h_coeffs_vec_kernel<svt::HC_THREADS, svt::HC_CHUNK_BITS>;
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
