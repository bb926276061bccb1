"""svt_fr_tape's own C++ (csrc/fr_tape.cu, with the real csrc/fe_inv.cuh),
run on the host against the plain interpreter `ff/fr_tape.py::run_plain`:
a schedule twin.  The kernel runs a tape's team schedule
(`ff/fr_tape.py::schedule`): a team of T threads a lane, a step's rows one
a thread, a `__syncwarp` between steps, a [slot][lane][word] slot file in
shared memory read and written 16 bytes at a time; this test runs that
code as the card does, a std::thread per thread of the warp and a
std::barrier of the 32 for `__syncwarp` (a thread that reads a slot before
its writer's step has passed the barrier, or after a later step has
reused it, shows as a wrong value; the slot file starts each block filled
with a pattern).

`svt_fr_powers` (csrc/accumulation_kernels.cu) runs as the kernel runs it,
a warp a transcript: one std::thread per lane, `__shfl_up_sync` and
`__shfl_sync` an exchange through the warp's slots between two barriers (a
lane that reads the wrong lane or a stale value shows as a wrong power),
against `pcs/kzg/accumulation.py::powers_plain` and python ints, for N on
both sides of the warp's 32 lanes and of its chunk carries.

g++ compiles the sources with the launch syntax stripped, a stub of the CUDA
runtime, and a portable C++ stand-in for csrc/fq.cuh's field functions for
both fields (whose inline-PTX carry chains tests/test_torch_mul_schedule.py
runs word by word).  The programs are the recorded vanilla PLONK k=10
(SHPLONK), GWC19 and IPA k = 11 plans and a hand-made tape through every
op, at every team size (1, 2, 4, 8) and at the wrapper's choice; the
batch is ragged (5 lanes): two fixture proofs' gathered inputs, random lazy
words and zeros (every batch inversion then meets zeros).  Skips inside the
test where no g++ is found.

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
from snark_verifier_tpu_torch.pcs.ipa import fixtures as ipa_fx
from snark_verifier_tpu_torch.pcs.ipa import ipa_plan
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
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

# A warp's lanes are threads: threadIdx is each thread's own, __syncwarp a
# barrier of the warp's 32 threads.
TEAM_RUNTIME_STUB = RUNTIME_STUB.replace("extern dim3_ threadIdx, blockIdx;", r"""
extern thread_local dim3_ threadIdx, blockIdx;
#include <barrier>
extern thread_local std::barrier<>* svt_warp_barrier;
inline void __syncwarp(unsigned = 0xffffffffu) { svt_warp_barrier->arrive_and_wait(); }
""")

# Reads (B, n_steps, team, n_in, n_out, n_const, n_slots), the schedule's steps, the
# constants and the inputs; runs the grid a block at a time, a thread per
# thread of the block's warp, through the kernel's own body.  The slot file
# is filled with a pattern before each block, so a read of a slot no row of
# the block wrote shows as a wrong value.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
#include "fr_tape.cpp"
namespace svt { uint4 tape_slot_file[TAPE_SMEM_BYTES / 16]; }
static std::vector<uint32_t> rd(FILE* f, size_t n) {
  std::vector<uint32_t> v(n ? n : 1);
  if (n && fread(v.data(), 4, n, f) != n) exit(3);
  return v; }
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[7];
  if (fread(h, 8, 7, f) != 7) return 2;
  const long long B = h[0], n_steps = h[1], team = h[2], n_in = h[3], n_out = h[4], n_const = h[5],
                  n_slots = h[6];
  auto steps = rd(f, n_steps * team * 4), consts = rd(f, n_const * 8), in = rd(f, n_in * B * 8);
  std::vector<uint32_t> out(n_out * B * 8, 0xdeadbeefu);
  const long long lanes = 32 / team;
  for (long long blk = 0; blk < (B + lanes - 1) / lanes; blk++) {
    for (auto& q : svt::tape_slot_file) q = uint4{0xa5a5a5a5u, 0x5a5a5a5au, 0xa5a5a5a5u, 0x5a5a5a5au};
    std::barrier<> warp(32);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < 32; t++)
      threads.emplace_back([&, t] {
        blockIdx.x = (unsigned)blk; threadIdx.x = t; svt_warp_barrier = &warp;
        svt::fr_tape_kernel((const int4*)steps.data(), (int)n_steps, (int)team, (int)n_slots,
                            consts.data(), (int)n_const, in.data(), (int)n_in, out.data(), B); });
    for (auto& th : threads) th.join();
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
    """run(tape, inputs, team) -> the kernel's outputs under g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    d = tmp_path_factory.mktemp("fr_tape_schedule")
    (d / "cuda_runtime.h").write_text(TEAM_RUNTIME_STUB)
    # fq.cuh's functions without its Fermat fe_inv: the kernel's INV is
    # fe_inv.cuh's binary GCD, and one that called fe_inv would not build
    (d / "fq.cuh").write_text(FIELD_STUB[:FIELD_STUB.index("template <int F> inline void fe_inv")]
                              + "}  // namespace svt\n")
    (d / "fe_inv.cuh").write_text((CSRC / "fe_inv.cuh").read_text())
    src = (CSRC / "fr_tape.cu").read_text()
    (d / "fr_tape.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o",
                    str(d / "harness"), str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)

    def run(tape, inputs, team):
        sched = tape.schedule(team)
        B = inputs.shape[1]
        inp, out = d / f"in_{team}.bin", d / f"out_{team}.bin"
        with open(inp, "wb") as f:
            f.write(np.array([B, sched.n_steps, team, inputs.shape[0], len(tape.outputs),
                              tape.consts.shape[0], sched.n_slots], np.int64).tobytes())
            f.write(np.ascontiguousarray(sched.steps).tobytes())
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
    """The vanilla_k10 plan and a (n_in, 5, 8) input block: fixtures 0 and 1
    as the transcript reads them, random lazy words, zeros, random lazy
    words (a ragged batch at every team size but 32 / 32)."""
    snarks = [Snark.load(str(FIXTURES / f"snark_{i:02d}.json")) for i in range(2)]
    plan = succinct_plan(snarks[0].protocol, Bdfg21, "shplonk", "poseidon")
    dev = torch.device("cpu")
    sc, pts = agg._stack_streams(snarks, dev)
    inst = agg._stack_instances(snarks, dev)
    reads = plan.read(inst, PoseidonTranscript(sc, pts, dev), TorchLoader(2, dev))
    fixture = plan.gather(inst, reads, 2)
    n_in = fixture.shape[0]
    rand = _lazy_words(np.random.default_rng(6), 2 * n_in).reshape(2, n_in, 8).transpose(0, 1)
    zeros = torch.zeros((n_in, 1, 8), dtype=torch.int32)
    return plan, torch.cat([fixture, rand[:, :1], zeros, rand[:, 1:]], 1).contiguous()


@pytest.fixture(scope="module")
def tapes(plan_inputs):
    """{name: (tape, inputs, run_plain's outputs)}: the vanilla_k10 plan on
    `plan_inputs`; the GWC19 plan and the IPA k = 11 plan on four lanes of
    random lazy words and one of zeros."""
    plan, inputs = plan_inputs
    gwc = succinct_plan(Snark.load(str(FIXTURES / "gwcsnark_00.json")).protocol, Gwc19, "gwc",
                        "poseidon").tape
    ipa = ipa_plan("ipa", ipa_fx.ipa_keys()[0].svk, device="cpu").tape
    out = {"shplonk": (plan.tape, inputs)}
    for k, (name, tape) in enumerate((("gwc19", gwc), ("ipa_k11", ipa))):
        n_in = len(tape.inputs)
        rand = _lazy_words(np.random.default_rng(40 + k), 4 * n_in).reshape(4, n_in, 8)
        ins = torch.cat([rand[:3], torch.zeros((1, n_in, 8), dtype=torch.int32), rand[3:]])
        out[name] = (tape, ins.transpose(0, 1).contiguous())
    return {name: (tape, ins, ft.run_plain(tape, ins)) for name, (tape, ins) in out.items()}


def test_kernel_body_matches_run_plain(harness, tapes):
    tape, inputs, want = tapes["shplonk"]
    got = harness(tape, inputs, ft.TEAM)
    assert torch.equal(got, want)
    assert not torch.equal(want[:, 0], want[:, 1])
    assert not torch.equal(want[:, 2], want[:, 3])


@pytest.mark.parametrize("team", ft.TEAMS)
@pytest.mark.parametrize("name", ["shplonk", "gwc19", "ipa_k11"])
def test_team_kernel_body_matches_run_plain(harness, tapes, name, team):
    """Every team size on a ragged batch of 5 (the last block's lanes past
    B run the steps and store nothing): word for word."""
    tape, inputs, want = tapes[name]
    assert torch.equal(harness(tape, inputs, team), want)


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
    for team in ft.TEAMS:
        assert torch.equal(harness(tape, inputs, team), want), team
    # the lane with y = 0: ONE_IF_ZERO gives 1, ZERO_IF_ZERO 0
    assert want[1, 2].tolist() == [1] + [0] * 7 and not bool(want[2, 2].any())
    assert bool(want[2, :2].any(-1).all())


# The runtime stub with a warp's primitives: lanes are threads, and a
# shuffle leaves each lane's value in the warp's slot, then reads the
# source lane's (its own where the source is out of range, as the card's).
WARP_RUNTIME_STUB = RUNTIME_STUB.replace("extern dim3_ threadIdx, blockIdx;", r"""
extern thread_local dim3_ threadIdx, blockIdx;
#include <barrier>
extern thread_local std::barrier<>* svt_warp_barrier;
extern thread_local uint32_t* svt_warp_slots;
inline uint32_t svt_exchange(uint32_t v, int src) {
  const int lane = threadIdx.x & 31;
  svt_warp_slots[lane] = v;
  svt_warp_barrier->arrive_and_wait();
  const uint32_t r = src >= 0 && src < 32 ? svt_warp_slots[src] : v;
  svt_warp_barrier->arrive_and_wait();
  return r; }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) { return svt_exchange(v, src & 31); }
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, unsigned k) {
  return svt_exchange(v, (int)(threadIdx.x & 31) - (int)k); }
""")

POWERS_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
thread_local uint32_t* svt_warp_slots;
#include "accumulation_kernels.cpp"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[2];
  if (fread(h, 8, 2, f) != 2) return 2;
  const long long B = h[0], n = h[1];
  std::vector<uint32_t> r(B * 8), out(B * n * 8);
  if (fread(r.data(), 4, r.size(), f) != r.size()) return 3;
  for (long long b = 0; b < B; b++) {  // a block a warp a transcript
    std::barrier<> bar(svt::POW_THREADS);
    uint32_t slots[32];
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < (unsigned)svt::POW_THREADS; t++)
      lanes.emplace_back([&, t] {
        blockIdx.x = (unsigned)b; threadIdx.x = t;
        svt_warp_barrier = &bar; svt_warp_slots = slots;
        svt::fr_powers_kernel(r.data(), (int)n, out.data(), B); });
    for (auto& th : lanes) th.join();
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def powers_harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    d = tmp_path_factory.mktemp("fr_powers_schedule")
    (d / "cuda_runtime.h").write_text(WARP_RUNTIME_STUB)
    (d / "fq.cuh").write_text(FIELD_STUB)
    src = (CSRC / "accumulation_kernels.cu").read_text()
    (d / "accumulation_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(POWERS_HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o", str(d / "h"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(r, n):
        inp, out = d / f"in_{n}.bin", d / f"out_{n}.bin"
        with open(inp, "wb") as f:
            f.write(np.array([r.shape[0], n], np.int64).tobytes())
            f.write(r.numpy().tobytes())
        subprocess.run([str(d / "h"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(r.shape[0], n, 8))

    return run


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 65])
def test_powers_kernel_body_matches_powers_plain(powers_harness, n):
    # lazy words in [0, 2r], and zero as 0, r and 2r (r^1 = r then leaves
    # from_mont as r itself, which only canon maps to 0)
    zeros = limbs_to_words(torch.tensor([[(k * FR.p >> (16 * i)) & 0xFFFF for i in range(16)]
                                         for k in (0, 1, 2)]))
    r = torch.cat([_lazy_words(np.random.default_rng(n), 13), zeros]).contiguous()
    got = powers_harness(r, n)
    assert torch.equal(got, powers_plain(r, n))
    rinv = pow(1 << 256, -1, FR.p)
    vals = [sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row)) for row in r.tolist()]
    ints = [[sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(word)) for word in row]
            for row in got.tolist()]
    assert ints == [[pow(v * rinv % FR.p, i, FR.p) for i in range(n)] for v in vals]
