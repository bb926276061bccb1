// Clocks per team operation (csrc/tower_team.cuh) and per Fq2 product and
// Fq multiply on a lane, in a hot loop of one warp alone on the card: what
// one level of the pairing kernels' chain costs, and where.  Standalone
// (not part of the kernel library, which builds csrc/*.cu only):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o team_levels snark_verifier_tpu_torch/csrc/probe/team_levels.cu && ./team_levels
//
// Prints one line per case: clock64() cycles per iteration, 200 iterations
// (the second of two runs), each iteration ending in __syncwarp().  The
// operands are arbitrary words below 2^28 (the costs do not depend on them).
#include <cuda_runtime.h>

#include <cstdio>

#include "../tower_team.cuh"

using namespace svt;

struct ProbeTeam {
  Fq2 f[6], g[6], L[3];
  TeamScratch s;
};

template <int CASE>
__global__ void probe_kernel(const uint32_t* in, int iters, long long* clk, uint32_t* out) {
  __shared__ ProbeTeam m;
  const int lane = threadIdx.x & 31;
  if (lane < 24) {
    reinterpret_cast<uint4*>(m.f)[lane] = reinterpret_cast<const uint4*>(in)[lane];
    reinterpret_cast<uint4*>(m.g)[lane] = reinterpret_cast<const uint4*>(in + 96)[lane];
  }
  if (lane < 12) reinterpret_cast<uint4*>(m.L)[lane] = reinterpret_cast<const uint4*>(in + 192)[lane];
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < iters; i++) {
    if (CASE == 0) team_mul(m.f, m.f, m.g, m.s, lane);
    if (CASE == 1) team_sqr(m.f, m.f, m.s, lane);
    if (CASE == 2) team_mul_034(m.f, m.f, m.L, m.s, lane);
    if (CASE == 3) team_cyclo_sqr(m.f, m.f, m.s, lane);
    if (CASE == 4) {  // a product pass alone: 18 lanes, one Fq2 product each
      if (lane < 18) fq2_mul(m.s.P[lane], m.f[lane % 6], m.g[lane % 6]);
      __syncwarp();
      if (lane < 6) m.f[lane] = m.s.P[lane + 6];
      __syncwarp();
    }
    if (CASE == 5) {  // one Fq2 product on one lane
      if (lane == 0) fq2_mul(m.f[0], m.f[0], m.g[0]);
      __syncwarp();
    }
    if (CASE == 6) {  // one Fq multiply on one lane
      if (lane == 0) {
        uint32_t x[FQ_WORDS];
        fe_copy(x, m.f[0].c[0]);
        fe_mul<FQ>(x, x, m.g[0].c[0]);
        fe_copy(m.f[0].c[0], x);
      }
      __syncwarp();
    }
    if (CASE == 7) {  // x xi on six lanes
      if (lane < 6) fq2_mul_xi(m.f[lane], m.f[lane]);
      __syncwarp();
    }
    if (CASE == 8) {  // an Fq2 add on six lanes
      if (lane < 6) fq2_add(m.f[lane], m.f[lane], m.g[lane]);
      __syncwarp();
    }
  }
  const long long t1 = clock64();
  if (lane == 0) *clk = t1 - t0;
  if (lane < 24) reinterpret_cast<uint4*>(out)[lane] = reinterpret_cast<uint4*>(m.f)[lane];
}

int main() {
  const char* names[] = {"team_mul",      "team_sqr",      "team_mul_034",
                         "team_cyclo_sqr", "pass18_only",   "fq2_mul_1lane",
                         "fe_mul_1lane",   "mul_xi_6lanes", "fq2_add_6lanes"};
  void (*kernels[])(const uint32_t*, int, long long*, uint32_t*) = {
      probe_kernel<0>, probe_kernel<1>, probe_kernel<2>, probe_kernel<3>, probe_kernel<4>,
      probe_kernel<5>, probe_kernel<6>, probe_kernel<7>, probe_kernel<8>};
  uint32_t h[288];
  for (int i = 0; i < 288; i++) h[i] = (i * 2654435761u) & 0x0fffffffu;
  uint32_t *in, *out;
  long long* clk;
  cudaMalloc(&in, sizeof h);
  cudaMalloc(&out, 96 * 4);
  cudaMalloc(&clk, 8);
  cudaMemcpy(in, h, sizeof h, cudaMemcpyHostToDevice);
  const int iters = 200;
  for (int k = 0; k < 9; k++)
    for (int rep = 0; rep < 2; rep++) {
      kernels[k]<<<1, 32>>>(in, iters, clk, out);
      cudaDeviceSynchronize();
      long long c = 0;
      cudaMemcpy(&c, clk, 8, cudaMemcpyDeviceToHost);
      if (rep) printf("%-16s %8.1f clocks per iteration\n", names[k], (double)c / iters);
    }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
