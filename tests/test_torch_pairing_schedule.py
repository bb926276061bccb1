"""The pairing kernels' own C++ (csrc/tower.cuh, csrc/tower_team.cuh,
csrc/pairing_kernels.cu), run on the host against the python-int oracle: a
schedule twin.  The kernels run each Fq12 operation as a team of 32 lanes
(one warp a proof) exchanging Fq2 products through shared memory, by other
formulas than the plain versions (the complex square, the sparse line
product, the cyclotomic square, combined Frobenius coefficients) and skip
what the plain formulas do for nothing (the first Miller square of 1, tape
products by the register that holds 1, identity transforms); this test runs
that very code.

g++ (C++20) compiles the three sources with the launch syntax stripped, a
stub of the CUDA runtime and a portable C++ stand-in for csrc/fq.cuh's
field functions (whose inline-PTX carry chains
tests/test_torch_mul_schedule.py runs word by word).  A block runs as one
std::thread per lane; `__shared__` storage is the kernel's function-static
storage (one block runs at a time) and `__syncwarp()` a std::barrier of the
warp's 32 threads, so a lane that wrote too early or read too late shows
as a wrong value.  Batches of 5 proofs leave the second block of 4 teams
ragged.  Skips inside the test where no g++ is found.

Tolerance: exact, as canonical ints."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch.ec import py_ec
from snark_verifier_tpu_torch.ff import np_limbs_to_words
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.pairing import fq12_vm
from snark_verifier_tpu_torch.pairing import py_pairing as pp
from snark_verifier_tpu_torch.pairing.pairing import OPS, _mask, prepare_pairs
from snark_verifier_tpu_torch.tower import fq12_from_int, fq12_to_int, tower_from_int
from snark_verifier_tpu_torch.tower.encode import fq_mont

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"

RUNTIME_STUB = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
// A warp's lanes are threads; __syncwarp is their barrier.
extern thread_local std::barrier<>* svt_warp_barrier;
inline void __syncwarp(unsigned = 0xffffffffu) { svt_warp_barrier->arrive_and_wait(); }
template <class T> T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> cudaError_t cudaMemcpyToSymbol(T& sym, const void* src, size_t n) {
  std::memcpy(&sym, src, n); return 0; }
"""

# fq.cuh's functions, the same numbers, in portable C++ (64-bit columns).
FIELD_STUB = r"""
#pragma once
#include <cstdint>
namespace svt {
constexpr int FQ_WORDS = 8;
constexpr int FQ = 0;
constexpr uint32_t PW[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
template <int F> constexpr uint32_t fe_p(int k) { return PW[k]; }
static const uint32_t FIELD_ONE[1][8] = {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                          0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
inline void fe_copy(uint32_t r[8], const uint32_t a[8]) { for (int i = 0; i < 8; i++) r[i] = a[i]; }
inline uint32_t add8(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (uint64_t)a[i] + b[i]; r[i] = (uint32_t)c; c >>= 32; }
  return (uint32_t)c; }
inline uint32_t sub8(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  int64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (int64_t)a[i] - b[i]; r[i] = (uint32_t)c; c >>= 32; }
  return c ? 1u : 0u; }
inline void twice_p(uint32_t m[8]) { add8(m, PW, PW); }
inline void cond_sub(uint32_t r[8], const uint32_t s[8], const uint32_t m[8]) {
  uint32_t d[8]; const uint32_t b = sub8(d, s, m); for (int i = 0; i < 8; i++) r[i] = b ? s[i] : d[i]; }
template <int F> inline void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8], m[8]; add8(s, a, b); twice_p(m); cond_sub(r, s, m); }
template <int F> inline void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8], m[8]; const uint32_t br = sub8(d, a, b); twice_p(m);
  if (!br) for (int i = 0; i < 8; i++) m[i] = 0;
  add8(r, d, m); }
template <int F> inline void fe_neg(uint32_t r[8], const uint32_t a[8]) {
  uint32_t m[8]; twice_p(m); sub8(r, m, a); }
template <int F> inline void fe_canon(uint32_t r[8], const uint32_t a[8]) {
  uint32_t m[8]; twice_p(m); cond_sub(r, a, m); cond_sub(r, r, PW); }
template <int F> inline void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[10] = {0};
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) { c += (uint64_t)a[j] * b[i] + t[j]; t[j] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[8] = (uint32_t)c; t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * 0xe4866389u;
    c = ((uint64_t)m * PW[0] + t[0]) >> 32;
    for (int j = 1; j < 8; j++) { c += (uint64_t)m * PW[j] + t[j]; t[j - 1] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[7] = (uint32_t)c; t[8] = t[9] + (uint32_t)(c >> 32);
  }
  fe_copy(r, t); }
template <int F> inline void fe_inv(uint32_t r[8], const uint32_t a[8]) {
  static const uint32_t PM2[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                  0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
  uint32_t x[8], acc[8]; fe_copy(x, a); fe_copy(acc, FIELD_ONE[0]);
  for (int i = 253; i >= 0; i--) {
    fe_mul<F>(acc, acc, acc);
    if ((PM2[i >> 5] >> (i & 31)) & 1u) fe_mul<F>(acc, acc, x);
  }
  fe_copy(r, acc); }
inline void fq_mul9(uint32_t r[8], const uint32_t a[8]) {
  uint32_t acc[8]; fe_add<FQ>(acc, a, a); fe_add<FQ>(acc, acc, acc); fe_add<FQ>(acc, acc, acc);
  fe_add<FQ>(r, acc, a); }
}  // namespace svt
"""

# Reads (kind, lanes, op) and the kernel's arrays; runs the grid one block
# at a time, a thread per lane of the block (its shared memory is the
# kernel's function-static storage), a barrier per warp.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
#include "pairing_kernels.cpp"
static std::vector<uint32_t> rd(FILE* f, size_t n) {
  std::vector<uint32_t> v(n ? n : 1);
  if (n && fread(v.data(), 4, n, f) != n) exit(3);
  return v; }
template <class Kernel> static void grid(long long B, Kernel kernel) {
  const int T = svt::PAIR_THREADS;
  for (long long blk = 0; blk < (B + svt::PAIR_TEAMS - 1) / svt::PAIR_TEAMS; blk++) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int w = 0; w < T / 32; w++) bars.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> lanes;
    for (int t = 0; t < T; t++)
      lanes.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = (unsigned)blk; svt_warp_barrier = bars[t / 32].get();
        kernel(); });
    for (auto& l : lanes) l.join();
  } }
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[3];
  if (fread(h, 4, 3, f) != 3) return 2;
  const int kind = h[0], op = h[2], npairs = svt::PAIR_NPAIRS, ns = svt::PAIR_NSTEPS;
  const long long B = h[1];
  auto frob = rd(f, 3 * 6 * 2 * 8);
  svt_pairing_load_constants(frob.data());
  std::vector<uint32_t> out(B * 96);
  if (kind == 0) {
    auto xs = rd(f, B * npairs * 8), ys = rd(f, B * npairs * 8), zs = rd(f, B * npairs * 8);
    auto dbl = rd(f, ns * npairs * 48), addc = rd(f, ns * npairs * 48), fin = rd(f, 2 * npairs * 48);
    unsigned long long m[2];
    if (fread(m, 8, 2, f) != 2) return 2;
    grid(B, [&] { svt::miller_loop_kernel(xs.data(), ys.data(), zs.data(), dbl.data(), addc.data(),
                                          fin.data(), m[0], m[1], B, out.data()); });
  } else if (kind == 1) {
    auto fin = rd(f, B * 96);
    int nt;
    if (fread(&nt, 4, 1, f) != 1) return 2;
    auto tape = rd(f, nt * 4);
    grid(B, [&] { svt::final_exp_kernel(fin.data(), (const int4*)tape.data(), nt, B, out.data()); });
  } else {
    auto a = rd(f, B * 96), bb = rd(f, B * 96);
    grid(B, [&] { svt::fq12_op_kernel(op, a.data(), bb.data(), B, out.data()); });
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0; }
"""


# Reads n Fq2 values (2 x 8 words each) and writes a * xi for each: the
# one-reduction multiply by 9 of csrc/tower.cuh on the lazy range's ends.
XI_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
#include "tower.cuh"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<svt::Fq2> v;
  svt::Fq2 x;
  while (fread(&x, sizeof x, 1, f) == 1) v.push_back(x);
  for (auto& a : v) svt::fq2_mul_xi(a, a);
  FILE* o = fopen(argv[2], "wb");
  fwrite(v.data(), sizeof(svt::Fq2), v.size(), o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernels' C++ on the host")
    d = tmp_path_factory.mktemp("pairing_schedule")
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "fq.cuh").write_text(FIELD_STUB)
    for h in ("tower.cuh", "tower_team.cuh"):
        shutil.copy(CSRC / h, d / h)
    src = (CSRC / "pairing_kernels.cu").read_text()
    (d / "pairing_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    (d / "xi_harness.cpp").write_text(XI_HARNESS)
    for name in ("harness", "xi_harness"):
        subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o", str(d / name),
                        str(d / f"{name}.cpp")], check=True, capture_output=True, timeout=300)

    def run(kind, lanes, op, arrays):
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([kind, lanes, op], np.int32).tobytes())
            f.write(fq12_vm.transform_table().tobytes())
            for a in arrays:
                f.write(np.ascontiguousarray(a).tobytes())
        subprocess.run([str(d / "harness"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(lanes, 2, 3, 2, 8))

    def mul_xi(values):
        """[(a0, a1)] ints below 2^256 -> [(r0, r1)] ints, fq2_mul_xi's words."""
        inp, out = d / "xi_in.bin", d / "xi_out.bin"
        inp.write_bytes(b"".join(c.to_bytes(32, "little") for a in values for c in a))
        subprocess.run([str(d / "xi_harness"), str(inp), str(out)], check=True, timeout=60)
        raw = out.read_bytes()
        ints = [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(2 * len(values))]
        return list(zip(ints[::2], ints[1::2]))

    run.mul_xi = mul_xi
    return run


def _rand_f12s(n, seed):
    rng = np.random.default_rng(seed)
    v = [int.from_bytes(rng.bytes(32), "little") % FQ.p for _ in range(12 * n)]
    return [tuple(tuple((v[12 * b + 6 * i + 2 * j], v[12 * b + 6 * i + 2 * j + 1])
                        for j in range(3)) for i in range(2)) for b in range(n)]


def _miller(harness, pts, qs, zs=None):
    """The kernel's Miller loop over lanes of G1 pairs (affine int tuples;
    zs: each coordinate scaled by its lane's Z, None for infinity -> (0:1:0))."""
    xs, ys, dbl, addc, has_add, finals = prepare_pairs([(pts[0][k], q) for k, q in enumerate(qs)])
    rows_x, rows_y, rows_z = [], [], []
    for b, lane in enumerate(pts):
        for k, pt in enumerate(lane):
            z = 1 if zs is None else zs[b][k]
            if pt is None:
                x, y, z = 0, 1, 0
            else:
                x, y = pt[0] * z % FQ.p, pt[1] * z % FQ.p
            rows_x.append(fq_mont(x)), rows_y.append(fq_mont(y)), rows_z.append(fq_mont(z))
    enc = lambda rows: np_limbs_to_words(np.stack(rows))
    lo, hi = _mask(has_add)
    return harness(0, len(pts), 0, [enc(rows_x), enc(rows_y), enc(rows_z), dbl, addc,
                                              finals, np.array([lo, hi], np.int64)])


def _final_exp(harness, f_words):
    tape = fq12_vm.build_final_exp_tape()
    return harness(1, f_words.shape[0], 0,
                   [f_words.numpy(), np.array([tape.shape[0]], np.int32), tape])


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): an element of the cyclotomic subgroup."""
    m = pp.f12_mul(pp.f12_conj(f), pp.f12_inv(f))
    return pp.f12_mul(pp.f12_frob(m, 2), m)


F12_ZERO = tuple(tuple((0, 0) for _ in range(3)) for _ in range(2))


def test_mul_xi_stays_lazy_on_the_range_ends(harness):
    """a * xi = (9 a0 - a1, a0 + 9 a1) for a0, a1 in [0, 2p] (the lazy
    contract, ends included): right mod p and again in [0, 2p].  Linear,
    so raw integers stand in for Montgomery words."""
    p = FQ.p
    ends = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p]
    rng = np.random.default_rng(5)
    rand = [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(40)]
    values = [(a, b) for a in ends for b in ends] + list(zip(rand[::2], rand[1::2]))
    for (a0, a1), (r0, r1) in zip(values, harness.mul_xi(values)):
        assert r0 % p == (9 * a0 - a1) % p and r1 % p == (a0 + 9 * a1) % p
        assert r0 <= 2 * p and r1 <= 2 * p


def test_miller_schedule_matches_oracle(harness):
    g1, g2 = py_ec.G1_GEN, pp.G2_GEN
    qs = [g2, pp.g2_scalar_mul(g2, 31337)]
    lanes = [[py_ec.scalar_mul(g1, 777), g1], [g1, py_ec.scalar_mul(g1, 5)],
             [py_ec.scalar_mul(g1, 3), py_ec.scalar_mul(g1, 11)], [g1, g1],
             [py_ec.scalar_mul(g1, 2), py_ec.scalar_mul(g1, 99)]]
    f = _miller(harness, lanes, qs)
    for b, lane in enumerate(lanes):
        want = pp.miller_loop([(p, pp.prepare_g2(q)) for p, q in zip(lane, qs)])
        assert fq12_to_int(f[b]) == want


def test_final_exp_schedule_matches_oracle(harness):
    fs = _rand_f12s(4, 3)
    fs.append(F12_ZERO)  # 0 maps to 0
    got = fq12_to_int(_final_exp(harness, fq12_from_int(fs)))
    assert got[:4] == [pp.final_exponentiation(f) for f in fs[:4]]
    assert got[4] == fs[4]


def test_decide_schedule_projective_and_infinity(harness):
    """e(lhs, g2) e(rhs, -s g2) on toy values: a valid lane affine and
    projectively scaled, lhs + G, and both sides at infinity."""
    tau, k = 987654321, 1234567
    qs = [pp.G2_GEN, pp.g2_neg(pp.g2_scalar_mul(pp.G2_GEN, tau))]
    rhs = py_ec.scalar_mul(py_ec.G1_GEN, k)
    lhs = py_ec.scalar_mul(py_ec.G1_GEN, k * tau)
    bad = py_ec.add(lhs, py_ec.G1_GEN)
    lanes = [[lhs, rhs], [lhs, rhs], [bad, rhs], [None, None], [lhs, rhs]]
    zs = [[1, 1], [5, 11], [1, 1], [1, 1], [7, 1]]
    fe = fq12_to_int(_final_exp(harness, _miller(harness, lanes, qs, zs)))
    assert [v == pp.F12_ONE for v in fe] == [True, True, False, True, True]


@pytest.mark.parametrize("op", list(OPS))
def test_fq12_op_schedule_matches_oracle(harness, op):
    """Every op code on 5 elements; cyclo_square on subgroup elements and 0."""
    n = 5
    A, Bv = _rand_f12s(n, 11), _rand_f12s(n, 12)
    if op == "cyclo_square":
        A = [_cyclotomic(x) for x in A[:-1]] + [F12_ZERO]
    lines = [f[0] for f in _rand_f12s(n, 13)]
    a = fq12_from_int(A).numpy()
    if op == "mul_by_034":
        b = np.zeros(n * 96, np.int32)
        b[: n * 48] = tower_from_int(lines, 6).numpy().reshape(-1)
    else:
        b = fq12_from_int(Bv).numpy()
    got = fq12_to_int(harness(2, n, OPS[op], [a, b]))
    oracle = {
        "mul": lambda i: pp.f12_mul(A[i], Bv[i]), "square": lambda i: pp.f12_sq(A[i]),
        "mul_by_034": lambda i: pp.f12_mul_by_034(A[i], *lines[i]),
        "frob1": lambda i: pp.f12_frob(A[i], 1), "frob2": lambda i: pp.f12_frob(A[i], 2),
        "frob3": lambda i: pp.f12_frob(A[i], 3), "conj": lambda i: pp.f12_conj(A[i]),
        "inv": lambda i: pp.f12_inv(A[i]), "cyclo_square": lambda i: pp.f12_sq(A[i]),
    }[op]
    assert got == [oracle(i) for i in range(n)]
