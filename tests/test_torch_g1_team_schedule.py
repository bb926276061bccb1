"""The G1 group law on teams of lanes (csrc/g1_team.cuh) and the two point
loops built on it (csrc/msm_loops.cuh: `svt_msm_windowed`,
`svt_bucket_reduce`), their own C++ run on the host: a schedule twin.

g++ (C++20) compiles the sources (msm_loops.cuh and msm_loops.cu) with each
`kernel<<<grid, block, ...>>>(...)`
launch turned into a call of the harness's grid runner, a stub of the CUDA
runtime and tests/test_torch_pairing_schedule.py's portable C++ stand-in
for csrc/fq.cuh's field functions (whose inline-PTX carry chains
tests/test_torch_mul_schedule.py runs word by word).  A block runs as one
std::thread per lane; `__shared__` storage is function-static (one block
runs at a time), `__syncwarp()` a std::barrier of the warp's 32 threads and
`__syncthreads()` one of the block's, so a lane that writes a team's slots
too early or reads them too late shows as a wrong value.

* Team operations, T = 1, 2, 4, 6 (T = 1 is g1.cuh's g1_add / g1_double):
  every lane of every team, the ragged last team of T = 6 aside, equals
  T = 1 word for word, with the output fresh and aliasing an operand, and
  in a chain of back-to-back operations; T = 1 equals the plain version's
  words (ec/curve.py's formulas) and python ints.
* The C entry points themselves, geometry included: `svt_msm_windowed` at
  both team sizes (1 and 6) and at the wrapper's layout, n = 0, 1, 26, 33, identity and
  repeated bases, scalars 0, 1, r - 1, r - 2, 2^256 - 1; `svt_bucket_reduce`
  on the MSM's (32, 256) bucket shape: against python ints.
* The kernel's GLV split (`glv_split`) against ec/glv.py::split, word for
  word.

Skips inside each test where no g++ is found.  Tolerance: exact (words
where the formulas are the same, affine points otherwise)."""

import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_pairing_schedule as pairing_schedule
from snark_verifier_tpu_torch.ec import from_affine_int, glv, limbs_to_words, py_ec
from snark_verifier_tpu_torch.ec import to_affine_int
from snark_verifier_tpu_torch.ec import words_to_limbs
from snark_verifier_tpu_torch.ff import FR
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.msm import pippenger as pip

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
TEAMS = (1, 2, 4, 6)  # g1_team.cuh's team sizes the kernels and their probe instantiate

RUNTIME_STUB = pairing_schedule.RUNTIME_STUB + r"""
#include <atomic>
#define __noinline__ __attribute__((noinline))
extern thread_local std::barrier<>* svt_block_barrier;
inline void __syncthreads() { svt_block_barrier->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T> T __ldcg(const T* p) { return *p; }
unsigned __shfl_xor_sync(unsigned, unsigned, int);  // declared for g1.cuh; never called here
extern dim3_ gridDim, blockDim;
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return 0; }
"""

FIELD_STUB = pairing_schedule.FIELD_STUB.replace("}  // namespace svt", r"""
inline void fq_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) { fe_add<FQ>(r, a, b); }
inline void fq_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) { fe_sub<FQ>(r, a, b); }
inline void fq_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) { fe_mul<FQ>(r, a, b); }
template <int F> inline void fe_sqr(uint32_t r[8], const uint32_t a[8]) { fe_mul<F>(r, a, a); }
// (a b + c d + M p) / R, word-serial, both products a row, one reduction.
template <int F> inline void fe_mul_sum(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                        const uint32_t c[8], const uint32_t d[8]) {
  uint32_t t[10] = {0};
  for (int i = 0; i < 8; i++) {
    for (int k = 0; k < 2; k++) {
      const uint32_t* x = k ? c : a;
      const uint32_t y = k ? d[i] : b[i];
      uint64_t cy = 0;
      for (int j = 0; j < 8; j++) { cy += (uint64_t)x[j] * y + t[j]; t[j] = (uint32_t)cy; cy >>= 32; }
      cy += t[8]; t[8] = (uint32_t)cy; t[9] += (uint32_t)(cy >> 32);
    }
    const uint32_t m = t[0] * 0xe4866389u;
    uint64_t cy = ((uint64_t)m * PW[0] + t[0]) >> 32;
    for (int j = 1; j < 8; j++) { cy += (uint64_t)m * PW[j] + t[j]; t[j - 1] = (uint32_t)cy; cy >>= 32; }
    cy += t[8]; t[7] = (uint32_t)cy; cy >>= 32;
    cy += t[9]; t[8] = (uint32_t)cy; t[9] = (uint32_t)(cy >> 32);
  }
  fe_copy(r, t); }
}  // namespace svt""")

# Runs a grid one block at a time, a thread per lane, a barrier per warp
# and one per block; the launches of msm_loops.cu call it.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
thread_local std::barrier<>* svt_block_barrier;
dim3_ gridDim, blockDim;
template <class Kernel> void svt_grid(long long blocks, int threads, Kernel kernel) {
  gridDim.x = (unsigned)blocks; blockDim.x = (unsigned)threads;
  for (long long blk = 0; blk < blocks; blk++) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int w = 0; w < threads / 32; w++) bars.emplace_back(new std::barrier<>(32));
    std::barrier<> block(threads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; t++)
      lanes.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = (unsigned)blk;
        svt_warp_barrier = bars[t / 32].get(); svt_block_barrier = &block;
        kernel(); });
    for (auto& l : lanes) l.join();
  } }
#include "msm_loops.cpp"
static std::vector<uint32_t> rd(FILE* f, size_t n) {
  std::vector<uint32_t> v(n ? n : 1);
  if (n && fread(v.data(), 4, n, f) != n) exit(3);
  return v; }
constexpr int OUTS = 6;  // a lane's outputs in team mode
// One warp of teams of T lanes; team k (k < 32 / T) works on pair k % np,
// the ragged team on pair 0.  A lane's outputs: p + q into a fresh point,
// into p and into q; 2p fresh and into p; and x <- 2x + q three times.
template <int T> void teams(const uint32_t* pq, int np, uint32_t* out) {
  svt_grid(1, 32, [&] {
    static svt::G1TeamSlots slots[svt::team_slots<T>()];
    const int lane = threadIdx.x, k = lane / T, r = lane % T;
    const int pair = k < svt::team_whole<T>() ? k % np : 0;
    const svt::G1SharedExchange s(slots[k], lane - r);
    svt::G1 p, q, o[OUTS];
    svt::g1_load(p, pq + pair * 48);
    svt::g1_load(q, pq + pair * 48 + 24);
    svt::g1_team_add<T>(o[0], p, q, s, r);
    o[1] = p; svt::g1_team_add<T>(o[1], o[1], q, s, r);
    o[2] = q; svt::g1_team_add<T>(o[2], p, o[2], s, r);
    svt::g1_team_double<T>(o[3], p, s, r);
    o[4] = p; svt::g1_team_double<T>(o[4], o[4], s, r);
    o[5] = p;
    for (int i = 0; i < 3; i++) {
      svt::g1_team_double<T>(o[5], o[5], s, r);
      svt::g1_team_add<T>(o[5], o[5], q, s, r);
    }
    for (int i = 0; i < OUTS; i++) svt::g1_store(out + (lane * OUTS + i) * 24, o[i]);
  }); }
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[5];
  if (fread(h, 4, 5, f) != 5) return 2;
  const int mode = h[0], team = h[1];
  std::vector<uint32_t> out;
  int err = 0;
  if (mode == 0) {  // team operations over np pairs
    const int np = h[2];
    auto pq = rd(f, np * 48);
    out.resize(32 * OUTS * 24);
    if (team == 1) teams<1>(pq.data(), np, out.data());
    if (team == 2) teams<2>(pq.data(), np, out.data());
    if (team == 4) teams<4>(pq.data(), np, out.data());
    if (team == 6) teams<6>(pq.data(), np, out.data());
  } else if (mode == 1) {  // svt_msm_windowed over (B, n) with (team, per_block)
    const long long B = h[2];
    const int n = h[3], per_block = h[4];
    auto pts = rd(f, B * n * 24), sc = rd(f, B * n * 8);
    out.resize(B * 24);
    err = svt_msm_windowed(pts.data(), sc.data(), B, n, team, per_block, out.data(), nullptr);
  } else if (mode == 3) {  // glv_split of n scalars: |k1| (4 words), k1 < 0, |k2|, k2 < 0
    const int n = h[2];
    auto ks = rd(f, n * 8);
    out.resize(n * 10);
    for (int i = 0; i < n; i++) {
      bool n1, n2;
      svt::glv_split(ks.data() + 8 * i, out.data() + 10 * i, n1, out.data() + 10 * i + 5, n2);
      out[10 * i + 4] = n1;
      out[10 * i + 9] = n2;
    }
  } else {  // svt_bucket_reduce over (32, 256) buckets
    auto buckets = rd(f, 32 * 256 * 24);
    std::vector<uint32_t> part(32 * 24 + 1);
    out.resize(24);
    err = svt_bucket_reduce(buckets.data(), part.data(), out.data(), nullptr);
  }
  if (err) return 10 + err;
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0; }
"""

LAUNCH = re.compile(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _host_source(src: str) -> str:
    """`kernel<<<grid, block, smem, stream>>>(args);` -> a call of the
    harness's grid runner with `kernel(args)` run on every lane."""
    def launch(m):
        grid, block = [a.strip() for a in m.group(2).split(",")[:2]]
        return f"svt_grid({grid}, {block}, [&] {{ {m.group(1)}({m.group(3)}); }});"
    return LAUNCH.sub(launch, src)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernels' C++ on the host")
    d = tmp_path_factory.mktemp("g1_team_schedule")
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "fq.cuh").write_text(FIELD_STUB)
    for h in ("g1.cuh", "g1_team.cuh"):
        shutil.copy(CSRC / h, d / h)
    for name in ("msm_loops.cuh", "msm_loops.cu"):
        src = _host_source((CSRC / name).read_text())
        assert "<<<" not in src
        (d / name.replace(".cu", ".cpp").replace(".cpph", ".cuh")).write_text(src)
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(header, arrays, n_out, tail=(3, 8)):
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array(header, np.int32).tobytes())
            for a in arrays:
                f.write(np.ascontiguousarray(a, dtype=np.int32).tobytes())
        subprocess.run([str(d / "harness"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(n_out, *tail))

    return run


def _affine(words):
    return to_affine_int(words_to_limbs(words))


def _mont_words(vals):
    """Ints below 2^256 -> (len, 8) int32 words, least significant first."""
    raw = np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in vals), dtype="<i4")
    return torch.from_numpy(raw.reshape(-1, 8).copy())


def _projective(aff, z, lazy=False):
    """Affine points (None: the identity) -> (len, 3, 8) Montgomery words of
    (x z : y z : z), each coordinate + p where `lazy` (the [0, 2p] range)."""
    p, R = FQ.p, 1 << 256
    rows = []
    for pt, zz in zip(aff, z):
        x, y, zc = (0, 1, 0) if pt is None else (pt[0] * zz % p, pt[1] * zz % p, zz % p)
        rows.append([(c * R % p) + (p if lazy else 0) for c in (x, y, zc)])
    return _mont_words([c for row in rows for c in row]).view(-1, 3, 8)


def _pairs():
    """16 (p, q) pairs: random, P == Q, P == -Q, identities, scaled and
    lazy projective words."""
    g = py_ec.rand_points(12, seed=7)
    neg = (g[2][0], FQ.p - g[2][1])
    ps = [g[0], g[1], g[2], None, g[3], None, g[4], g[5], g[6], g[7], g[8], g[9], g[10], g[11],
          g[0], g[1]]
    qs = [g[4], g[1], neg, g[5], None, None, g[6], g[7], g[6], g[8], g[9], g[0], g[11], g[10],
          g[0], g[2]]
    rng = random.Random(8)
    zp = [1, 1, 5, 1, 7, 3] + [rng.randrange(1, FQ.p) for _ in range(10)]
    zq = [1, 9, 1, 2, 1, 1] + [rng.randrange(1, FQ.p) for _ in range(10)]
    pw, qw = _projective(ps, zp), _projective(qs, zq)
    pw[10:13] = _projective(ps[10:13], zp[10:13], lazy=True)
    qw[11:14] = _projective(qs[11:14], zq[11:14], lazy=True)
    return ps, qs, pw, qw


@pytest.fixture(scope="module")
def team_outputs(harness):
    ps, qs, pw, qw = _pairs()
    pq = torch.stack([pw, qw], 1)  # (16, 2, 3, 8)
    outs = {t: harness([0, t, len(ps), 0, 0], [pq.numpy()], 32 * 6).view(32, 6, 3, 8)
            for t in TEAMS}
    return ps, qs, pw, qw, outs


def test_team_one_is_g1_cuh_and_the_plain_formulas(team_outputs):
    """T = 1 runs g1.cuh's g1_add / g1_double: the plain version's words
    (ec/curve.py's formulas, the same field operations) and python ints."""
    ps, qs, pw, qw, outs = team_outputs
    o = outs[1][:16]
    add, dbl = cuda_ops.add_plain(pw, qw), cuda_ops.double_plain(pw)
    for i in range(3):
        assert torch.equal(o[:, i], add)
    assert torch.equal(o[:, 3], dbl) and torch.equal(o[:, 4], dbl)
    chain = pw
    for _ in range(3):
        chain = cuda_ops.add_plain(cuda_ops.double_plain(chain), qw)
    assert torch.equal(o[:, 5], chain)
    assert _affine(o[:, 0]) == [py_ec.add(p, q) for p, q in zip(ps, qs)]
    assert _affine(o[:, 3]) == [py_ec.double(p) for p in ps]


@pytest.mark.parametrize("team", [t for t in TEAMS if t > 1])
def test_team_operations_equal_g1_cuh_word_for_word(team_outputs, team):
    """Every lane of team k holds pair k's outputs, the same words as one
    lane's g1_add / g1_double, fresh and aliased, and after a chain of six
    back-to-back operations."""
    ps, qs, pw, qw, outs = team_outputs
    one = outs[1][:16]
    got = outs[team]
    for lane in range(32 // team * team):
        k = lane // team
        assert torch.equal(got[lane], one[k % 16]), (team, lane)


# ------------------------------------------------------------- the point loops


def _bases(n, seed):
    pts = py_ec.rand_points(n, seed=seed)
    if n >= 2:
        pts[1] = None
    if n >= 4:
        pts[3] = pts[2]
    if n >= 33:
        pts[32] = pts[0]
    return pts


def _scalars(n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(FR.p) for _ in range(n)]
    for i, k in enumerate((FR.p - 1, 0, (1 << 256) - 1, 1, FR.p - 2)):
        if i < n:
            ks[i] = k
    return ks


@pytest.mark.parametrize("n", [0, 1, 26, 33])
def test_msm_windowed_entry_matches_oracle(harness, n):
    """Three proofs (two a block leaves the second block ragged) at both
    team sizes, and one block a proof at the wrapper's layout for 132 SMs."""
    B = 3
    aff = [_bases(n, 10 + b) for b in range(B)]
    kss = [_scalars(n, 20 + b) for b in range(B)]
    pts = torch.stack([limbs_to_words(from_affine_int(a)) if n else torch.zeros(0, 3, 8,
                       dtype=torch.int32) for a in aff])
    sc = torch.stack([_mont_words(ks) if n else torch.zeros(0, 8, dtype=torch.int32)
                      for ks in kss])
    want = [py_ec.msm(a, [k % FR.p for k in ks]) if n else None for a, ks in zip(aff, kss)]
    layouts = {(t, 2) for t in cuda_ops.MSMW_TEAMS} | {cuda_ops.msm_windowed_layout(B, n, 132)}
    for team, per_block in sorted(layouts):
        got = harness([1, team, B, n, per_block], [pts.numpy(), sc.numpy()], B)
        assert _affine(got) == want, (team, per_block)


def test_glv_split_is_the_python_formula(harness):
    """The kernel's glv_split gives ec/glv.py::split's halves, sign and
    magnitude, word for word: random scalars below r and 2^256, and the
    edges 0, 1, λ, r - 1, r - 2, 2^256 - 1."""
    rng = random.Random(23)
    ks = [rng.randrange(FR.p) for _ in range(60)] + [rng.randrange(1 << 256) for _ in range(30)]
    ks += [0, 1, glv.LAMBDA, FR.p - 1, FR.p - 2, (1 << 256) - 1]
    got = harness([3, 0, len(ks), 0, 0], [_mont_words(ks).numpy()], len(ks), (10,)).numpy()
    got = got.astype(np.int64) & 0xFFFFFFFF
    for k, row in zip(ks, got):
        k1, k2 = glv.split(k)
        mag = [sum(int(w) << (32 * i) for i, w in enumerate(row[o:o + 4])) for o in (0, 5)]
        assert (mag[0], bool(row[4]), mag[1], bool(row[9])) == (abs(k1), k1 < 0, abs(k2), k2 < 0)


@pytest.mark.parametrize("kind", ["random", "one bucket per window"])
def test_bucket_reduce_entry_matches_oracle(harness, kind):
    """The MSM's (32, 256) with its top window padded past bucket 48, or one
    bucket a window at the teams' block edges (bucket 0 among them)."""
    if kind == "random":
        k = np.random.default_rng(91).integers(0, 8, size=(32, 256))
        k[0] = 0
        k[-1, pip.top_range(8):] = 0
    else:
        k = np.zeros((32, 256), dtype=np.int64)
        edges = (0, 7, 8, 15, 120, 127, 128, 135, 248, 255, 1)
        for w in range(32):
            k[w, edges[w % len(edges)]] = 1 + w % 7
    pool = limbs_to_words(from_affine_int(
        [py_ec.scalar_mul(py_ec.G1_GEN, j) for j in range(int(k.max()) + 1)]))
    buckets = pool[torch.from_numpy(k)]
    total = sum((b * int(k[w, b])) << (8 * w) for w in range(32) for b in range(256))
    got = harness([2, 0, 0, 0, 0], [buckets.numpy()], 1)
    assert _affine(got) == [py_ec.scalar_mul(py_ec.G1_GEN, total % FR.p)]
