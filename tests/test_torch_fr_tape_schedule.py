"""svt_fr_tape's own C++ (csrc/fr_tape.cu), run on the host against the
plain interpreter `ff/fr_tape.py::run_plain`: a schedule twin.  The kernel
squares where both operands are one value, reads its operands from a
[slot][word][lane] slot file, and picks its ops by row; this test runs that
code, lane by lane.

`svt_fr_powers` (csrc/accumulation_kernels.cu) runs the same way, thread by
thread, against `pcs/kzg/accumulation.py::powers_plain`.

g++ compiles the sources with the launch syntax stripped, a stub of the CUDA
runtime, and a portable C++ stand-in for csrc/fq.cuh's field functions for
both fields (whose inline-PTX carry chains tests/test_torch_mul_schedule.py
runs word by word).  The program is the recorded vanilla PLONK k=10 plan;
the lanes are two fixture proofs' gathered inputs, one of random lazy
words, and one of zeros (every batch inversion then meets zeros).  Skips
inside the test where no g++ is found.

Tolerance: exact, word for word on the canonical outputs."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch.ff import FQ, FR, limbs_to_words
from snark_verifier_tpu_torch.ff import fr_tape as ft
from snark_verifier_tpu_torch.loader.base import TorchLoader
from snark_verifier_tpu_torch.pcs.kzg.accumulation import powers_plain
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
from snark_verifier_tpu_torch.sdk import aggregation as agg
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.transcript import PoseidonTranscript
from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "snark_verifier_tpu_torch" / "csrc"
FIXTURES = REPO / "benchmarks" / "fixtures" / "vanilla_k10"

RUNTIME_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx, blockIdx;
template <class T> T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
"""


def _words(x: int) -> str:
    return ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8))


# fq.cuh's Fr and Fq functions, the same numbers, in portable C++ (64-bit
# columns); tag 0 is Fq, 1 Fr, as in fq.cuh.
FIELD_STUB = (r"""
#pragma once
#include <cstdint>
namespace svt {
constexpr int FQ_WORDS = 8;
constexpr int FQ = 0;
constexpr int FR = 1;
static const uint32_t PW[2][8] = {{%(pq)s}, {%(pr)s}};
static const uint32_t PM2[2][8] = {{%(mq)s}, {%(mr)s}};
static const uint32_t PINV[2] = {%(iq)s, %(ir)s};
static const uint32_t FIELD_ONE[2][8] = {{%(oq)s}, {%(or_)s}};
inline void fe_copy(uint32_t r[8], const uint32_t a[8]) { for (int i = 0; i < 8; i++) r[i] = a[i]; }
inline uint32_t add8(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (uint64_t)a[i] + b[i]; r[i] = (uint32_t)c; c >>= 32; }
  return (uint32_t)c; }
inline uint32_t sub8(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  int64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (int64_t)a[i] - b[i]; r[i] = (uint32_t)c; c >>= 32; }
  return c ? 1u : 0u; }
template <int F> inline void twice_p(uint32_t m[8]) { add8(m, PW[F], PW[F]); }
inline void cond_sub(uint32_t r[8], const uint32_t s[8], const uint32_t m[8]) {
  uint32_t d[8]; const uint32_t b = sub8(d, s, m); for (int i = 0; i < 8; i++) r[i] = b ? s[i] : d[i]; }
template <int F> inline void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8], m[8]; add8(s, a, b); twice_p<F>(m); cond_sub(r, s, m); }
template <int F> inline void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8], m[8]; const uint32_t br = sub8(d, a, b); twice_p<F>(m);
  if (!br) for (int i = 0; i < 8; i++) m[i] = 0;
  add8(r, d, m); }
template <int F> inline void fe_neg(uint32_t r[8], const uint32_t a[8]) {
  uint32_t m[8]; twice_p<F>(m); sub8(r, m, a); }
template <int F> inline void fe_canon(uint32_t r[8], const uint32_t a[8]) {
  uint32_t m[8]; twice_p<F>(m); cond_sub(r, a, m); cond_sub(r, r, PW[F]); }
template <int F> inline void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  const uint32_t* P = PW[F];
  uint32_t t[10] = {0};
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) { c += (uint64_t)a[j] * b[i] + t[j]; t[j] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[8] = (uint32_t)c; t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * PINV[F];
    c = ((uint64_t)m * P[0] + t[0]) >> 32;
    for (int j = 1; j < 8; j++) { c += (uint64_t)m * P[j] + t[j]; t[j - 1] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[7] = (uint32_t)c; t[8] = t[9] + (uint32_t)(c >> 32);
  }
  fe_copy(r, t); }
template <int F> inline void fe_sqr(uint32_t r[8], const uint32_t a[8]) {
  uint32_t x[8]; fe_copy(x, a); fe_mul<F>(r, x, x); }
template <int F> inline void fe_inv(uint32_t r[8], const uint32_t a[8]) {
  uint32_t x[8], acc[8]; fe_copy(x, a); fe_copy(acc, FIELD_ONE[F]);
  for (int i = 253; i >= 0; i--) {
    fe_sqr<F>(acc, acc);
    if ((PM2[F][i >> 5] >> (i & 31)) & 1u) fe_mul<F>(acc, acc, x);
  }
  fe_copy(r, acc); }
}  // namespace svt
""" % {
    "pq": _words(FQ.p), "pr": _words(FR.p), "mq": _words(FQ.p - 2), "mr": _words(FR.p - 2),
    "iq": f"0x{(-pow(FQ.p, -1, 1 << 32)) % (1 << 32):08x}u",
    "ir": f"0x{(-pow(FR.p, -1, 1 << 32)) % (1 << 32):08x}u",
    "oq": _words((1 << 256) % FQ.p), "or_": _words((1 << 256) % FR.p),
})

# Reads (B, n_rows, n_in, n_out, n_const), the rows, the constants and the
# inputs; runs every lane through the kernel's own body.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
dim3_ threadIdx, blockIdx;
#include "fr_tape.cpp"
namespace svt { uint32_t tape_slot_file[TAPE_MAX_SLOTS * FQ_WORDS * TAPE_LANES]; }
static std::vector<uint32_t> rd(FILE* f, size_t n) {
  std::vector<uint32_t> v(n ? n : 1);
  if (n && fread(v.data(), 4, n, f) != n) exit(3);
  return v; }
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[5];
  if (fread(h, 8, 5, f) != 5) return 2;
  const long long B = h[0], n_rows = h[1], n_in = h[2], n_out = h[3], n_const = h[4];
  auto rows = rd(f, n_rows * 4), consts = rd(f, n_const * 8), in = rd(f, n_in * B * 8);
  std::vector<uint32_t> out(n_out * B * 8);
  for (long long b = 0; b < B; b++) {
    blockIdx.x = b / 32; threadIdx.x = b % 32;
    svt::fr_tape_kernel((const int4*)rows.data(), (int)n_rows, consts.data(), in.data(),
                        out.data(), B);
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    d = tmp_path_factory.mktemp("fr_tape_schedule")
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "fq.cuh").write_text(FIELD_STUB)
    src = (CSRC / "fr_tape.cu").read_text()
    (d / "fr_tape.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(d), "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(tape, inputs):
        B = inputs.shape[1]
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([B, len(tape.rows), inputs.shape[0], len(tape.outputs),
                              tape.consts.shape[0]], np.int64).tobytes())
            f.write(np.ascontiguousarray(tape.rows).tobytes())
            f.write(np.ascontiguousarray(tape.consts).tobytes())
            f.write(inputs.contiguous().numpy().tobytes())
        subprocess.run([str(d / "harness"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(len(tape.outputs), B, 8))

    return run


def _lazy_words(rng, n):
    """(n, 8) words of values uniform in [0, 2r], the lazy contract."""
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(n)]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(n, 16)))


@pytest.fixture(scope="module")
def plan_inputs():
    """The vanilla_k10 plan and a (n_in, 4, 8) input block: fixtures 0 and 1
    as the transcript reads them, random lazy words, zeros."""
    snarks = [Snark.load(str(FIXTURES / f"snark_{i:02d}.json")) for i in range(2)]
    plan = succinct_plan(snarks[0].protocol, Bdfg21, "shplonk", "poseidon")
    dev = torch.device("cpu")
    sc, pts = agg._stack_streams(snarks, dev)
    inst = agg._stack_instances(snarks, dev)
    reads = plan.read(inst, PoseidonTranscript(sc, pts, dev), TorchLoader(2, dev))
    fixture = plan.gather(inst, reads, 2)
    n_in = fixture.shape[0]
    rand = _lazy_words(np.random.default_rng(6), n_in)[:, None]
    zeros = torch.zeros((n_in, 1, 8), dtype=torch.int32)
    return plan, torch.cat([fixture, rand, zeros], 1).contiguous()


def test_kernel_body_matches_run_plain(harness, plan_inputs):
    plan, inputs = plan_inputs
    want = ft.run_plain(plan.tape, inputs)
    got = harness(plan.tape, inputs)
    assert torch.equal(got, want)
    assert not torch.equal(want[:, 0], want[:, 1])
    assert not torch.equal(want[:, 2], want[:, 3])


def test_kernel_body_squares_and_selects(harness):
    """A hand-made tape through every op: x², x·y, x + y, x − y, −x, 1/x,
    canon, both selects on a zero and a nonzero lane, constants and an
    input read twice."""
    R = 1 << 256
    one_c = ft.CONST << ft.KIND_SHIFT
    inp = lambda i: (ft.INPUT << ft.KIND_SHIFT) | i
    slot = lambda i: (ft.SLOT << ft.KIND_SHIFT) | i
    rows = np.array([
        (ft.MUL, 0, inp(0), inp(0)),            # s0 = x²
        (ft.MUL, 1, slot(0), inp(1)),           # s1 = x² y
        (ft.ADD, 2, slot(1), one_c),            # s2 = x² y + 3
        (ft.SUB, 2, slot(2), inp(0)),           # s2 -= x
        (ft.NEG, 3, slot(2), 0),                # s3 = -s2
        (ft.INV, 3, slot(3), 0),                # s3 = 1 / s3
        (ft.CANON, 4, slot(3), 0),
        (ft.ONE_IF_ZERO, 5, inp(1), 0),         # y or 1
        (ft.ZERO_IF_ZERO, 6, inp(1), slot(4)),  # s4 or 0
        (ft.OUT, 0, slot(4), 0),
        (ft.OUT, 1, slot(5), 0),
        (ft.OUT, 2, slot(6), 0),
    ], np.int32)
    consts = np.stack([limbs_to_words(torch.tensor(
        [(3 * R % FR.p >> (16 * i)) & 0xFFFF for i in range(16)])).numpy()])
    tape = ft.FrTape(rows=rows, consts=consts, inputs=["x", "y"], outputs=[0, 1, 2], n_slots=7)
    rng = np.random.default_rng(2)
    x = _lazy_words(rng, 3)
    y = torch.cat([_lazy_words(rng, 2), torch.zeros((1, 8), dtype=torch.int32)])
    inputs = torch.stack([x, y], 0).contiguous()
    want = ft.run_plain(tape, inputs)
    assert torch.equal(harness(tape, inputs), want)
    # the lane with y = 0: ONE_IF_ZERO gives 1, ZERO_IF_ZERO 0
    assert want[1, 2].tolist() == [1] + [0] * 7 and not bool(want[2, 2].any())
    assert bool(want[2, :2].any(-1).all())


POWERS_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
dim3_ threadIdx, blockIdx;
#include "accumulation_kernels.cpp"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[2];
  if (fread(h, 8, 2, f) != 2) return 2;
  const long long B = h[0], n = h[1];
  std::vector<uint32_t> r(B * 8), out(B * n * 8);
  if (fread(r.data(), 4, r.size(), f) != r.size()) return 3;
  for (long long b = 0; b < B; b++) {
    blockIdx.x = b / svt::POW_THREADS; threadIdx.x = b % svt::POW_THREADS;
    svt::fr_powers_kernel(r.data(), (int)n, out.data(), B);
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0; }
"""


@pytest.mark.parametrize("n", [1, 2, 33])
def test_powers_kernel_body_matches_powers_plain(tmp_path, n):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    (tmp_path / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (tmp_path / "fq.cuh").write_text(FIELD_STUB)
    src = (CSRC / "accumulation_kernels.cu").read_text()
    (tmp_path / "accumulation_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (tmp_path / "harness.cpp").write_text(POWERS_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(tmp_path), "-o", str(tmp_path / "h"),
                    str(tmp_path / "harness.cpp")], check=True, capture_output=True, timeout=300)
    # lazy words in [0, 2r] over more than one block, and zero as 0, r and 2r
    # (r^1 = r then leaves from_mont as r itself, which only canon maps to 0)
    zeros = limbs_to_words(torch.tensor([[(k * FR.p >> (16 * i)) & 0xFFFF for i in range(16)]
                                         for k in (0, 1, 2)]))
    r = torch.cat([_lazy_words(np.random.default_rng(n), 129), zeros]).contiguous()
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        f.write(np.array([r.shape[0], n], np.int64).tobytes())
        f.write(r.numpy().tobytes())
    subprocess.run([str(tmp_path / "h"), str(inp), str(out)], check=True, timeout=300)
    got = torch.from_numpy(np.fromfile(out, np.int32).reshape(r.shape[0], n, 8))
    assert torch.equal(got, powers_plain(r, n))
