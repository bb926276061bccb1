"""The keccak kernel's own C++, run on the host: a schedule twin.

g++ compiles csrc/keccak.cuh and holds its team permutation and its word
<-> lane codec against python ints: `hash/keccak.py::_keccak_f` on seeded
states and the byte order of the 32-byte big-endian word.  The permutation
runs as the kernel runs it, a warp a state: one std::thread per lane, a
64-bit sponge lane each, `__shfl_sync` an exchange through the warp's slots
between two barriers (a lane that reads the wrong lane or a stale value
shows as a wrong state) and `__syncwarp` a barrier.  The challenge is
csrc/fq.cuh's fe_mul<FR> with the kernel's R^2 table as the multiplicand
and a 256-bit hash (up to ~5.3 r, outside fe_mul's [0, 2r] inputs) as the
multiplier: its inline-PTX carry chains run through
tests/test_torch_mul_schedule.py's interpreter, which fails on a dropped
carry, for hashes of 0, r - 1, r, 2r, 5r and 2^256 - 1, against the
Montgomery form of the hash mod r.  Then g++ compiles csrc/keccak_kernels.cu
with the launch syntax stripped, a stub of the CUDA runtime and a portable
C++ stand-in for csrc/fq.cuh's multiply and canon (whose inline-PTX carry
chains tests/test_torch_mul_schedule.py runs word by word), and runs the
read kernel warp by warp (`__shared__` its function-static storage) on a
schedule of one squeeze of W = 1 ... 30 words with all three tags against
`keccak256` and the plain squeeze, and on reads that hash lane points (an
instance commitment's affine x and y) beside stream words against
`read_plain` and python ints; tests/test_torch_keccak_read.py runs it on
whole reads.  Skips inside the test where no g++ is found.

Tolerance: exact."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import test_torch_mul_schedule as mul_schedule
import torch

from snark_verifier_tpu_torch.ff import FQ, FR, FRW, limbs_to_words
from snark_verifier_tpu_torch.hash import keccak_device as kd
from snark_verifier_tpu_torch.hash.keccak import _keccak_f, keccak256

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "snark_verifier_tpu_torch" / "csrc"

RUNTIME_STUB = r"""
#pragma once
#include <barrier>
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
// A warp's lanes are threads: __syncwarp is their barrier, and a shuffle
// leaves each lane's value in the warp's slot, then reads the source's.
extern thread_local std::barrier<>* svt_warp_barrier;
extern thread_local uint32_t* svt_warp_slots;
inline void __syncwarp(unsigned = 0xffffffffu) { svt_warp_barrier->arrive_and_wait(); }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  svt_warp_slots[threadIdx.x & 31] = v;
  svt_warp_barrier->arrive_and_wait();
  const uint32_t r = svt_warp_slots[src & 31];
  svt_warp_barrier->arrive_and_wait();
  return r; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
"""

# Runs fn(lane) on the 32 lanes of one warp, a std::thread each.
WARP = r"""
#include <thread>
#include <vector>
thread_local dim3_ threadIdx, blockIdx;
thread_local std::barrier<>* svt_warp_barrier;
thread_local uint32_t* svt_warp_slots;
template <class Fn> void run_warp(unsigned block, unsigned warp, Fn fn) {
  std::barrier<> bar(32);
  uint32_t slots[32];
  std::vector<std::thread> th;
  for (unsigned t = 0; t < 32; t++)
    th.emplace_back([&, t] {
      blockIdx.x = block; threadIdx.x = 32 * warp + t;
      svt_warp_barrier = &bar; svt_warp_slots = slots;
      fn(t); });
  for (auto& x : th) x.join(); }
"""

def _words(x: int) -> str:
    return ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8))


# fq.cuh's fe_mul and fe_canon for both fields, the same numbers, in
# portable C++ (64-bit columns); tag 0 is Fq, 1 Fr, as in fq.cuh.
FIELD_STUB = (r"""
#pragma once
#include <cstdint>
namespace svt {
constexpr int FQ_WORDS = 8;
constexpr int FQ = 0;
constexpr int FR = 1;
static const uint32_t PW[2][8] = {{%(pq)s}, {%(pr)s}};
static const uint32_t PINV[2] = {%(iq)s, %(ir)s};
inline uint32_t sub8(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  int64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (int64_t)a[i] - b[i]; r[i] = (uint32_t)c; c >>= 32; }
  return c ? 1u : 0u; }
inline void cond_sub(uint32_t r[8], const uint32_t s[8], const uint32_t m[8]) {
  uint32_t d[8]; const uint32_t b = sub8(d, s, m);
  for (int i = 0; i < 8; i++) r[i] = b ? s[i] : d[i]; }
template <int F> inline void fe_canon(uint32_t r[8], const uint32_t a[8]) {
  uint32_t m[8]; uint64_t c = 0;
  for (int i = 0; i < 8; i++) { c += (uint64_t)PW[F][i] * 2; m[i] = (uint32_t)c; c >>= 32; }
  cond_sub(r, a, m); cond_sub(r, r, PW[F]); }
template <int F> inline void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  const uint32_t* P = PW[F];
  uint32_t t[10] = {0};
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) { c += (uint64_t)a[j] * b[i] + t[j]; t[j] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[8] = (uint32_t)c; t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * PINV[F];
    c = ((uint64_t)m * P[0] + t[0]) >> 32;
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * P[j] + t[j]; t[j - 1] = (uint32_t)c; c >>= 32; }
    c += t[8]; t[7] = (uint32_t)c; t[8] = t[9] + (uint32_t)(c >> 32);
  }
  for (int j = 0; j < 8; j++) r[j] = t[j]; }
}  // namespace svt
""" % {
    "pq": _words(FQ.p), "pr": _words(FR.p),
    "iq": f"0x{(-pow(FQ.p, -1, 1 << 32)) % (1 << 32):08x}u",
    "ir": f"0x{(-pow(FR.p, -1, 1 << 32)) % (1 << 32):08x}u",
})

# keccak.cuh alone: "perm" permutes 25-lane states by a warp, "codec" maps
# a value's words to lanes and back; records of uint64 / uint32 from one
# file into another.
PIECES = r"""
#include <cstdio>
#include <cstring>
#include "cuda_runtime.h"
#include "keccak.cuh"
#include "warp.h"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[2], "rb");
  FILE* o = fopen(argv[3], "wb");
  if (!strcmp(argv[1], "perm")) {
    uint64_t st[25], out[32];
    while (fread(st, 8, 25, f) == 25) {
      run_warp(0, 0, [&](unsigned t) {
        uint64_t a = st[t < 25 ? t : t - 25];
        svt::kc_team_permute(a, svt::kc_team_lane(t));
        out[t] = a; });
      fwrite(out, 8, 25, o); }
  } else {
    uint32_t w[8], back[8]; uint64_t l[4];
    while (fread(w, 4, 8, f) == 8) {
      svt::kc_word_to_lanes(w, l); svt::kc_lanes_to_word(l, back);
      fwrite(l, 8, 4, o); fwrite(back, 4, 8, o); }
  }
  fclose(o);
  return 0; }
"""

# The read kernel: reads a header (B, n_inst, n_sc, n_pt, n_consts, n_rows,
# n_sq, n_pad, n_lane_pts) and KcRead's arrays; runs every warp of the grid;
# writes the hashes (n_sq, B, 8) and the challenges (n_sq, B, 8).
KERNEL = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "cuda_runtime.h"
#include "warp.h"
#include "keccak_kernels.cpp"
template <class T> static std::vector<T> rd(FILE* f, size_t n) {
  std::vector<T> v(n ? n : 1);
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(3);
  return v; }
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[9];
  if (fread(h, 8, 9, f) != 9) return 2;
  const long long B = h[0], n_inst = h[1], n_sc = h[2], n_pt = h[3], n_consts = h[4];
  const long long n_rows = h[5], n_sq = h[6], n_pad = h[7], n_lane_pts = h[8];
  auto inst = rd<uint32_t>(f, B * n_inst * 8), consts = rd<uint32_t>(f, n_consts * 8);
  auto scalars = rd<uint32_t>(f, B * n_sc * 8), points = rd<uint32_t>(f, B * n_pt * 16);
  auto rows = rd<int>(f, n_rows * 3), starts = rd<int>(f, n_sq + 1);
  auto pad = rd<uint32_t>(f, n_pad * 2);
  auto pad_starts = rd<int>(f, n_sq + 1);
  auto lane_pts = rd<uint32_t>(f, B * n_lane_pts * 16);
  std::vector<uint32_t> hash(n_sq * B * 8), chal(n_sq * B * 8);
  const svt::KcRead s{inst.data(), (int)n_inst, consts.data(), scalars.data(), (int)n_sc,
                      points.data(), (int)n_pt, lane_pts.data(), (int)n_lane_pts, rows.data(),
                      starts.data(), pad.data(),
                      pad_starts.data(), (int)n_sq, hash.data(), chal.data(), B};
  for (long long b = 0; b < B; b++)
    run_warp((unsigned)(b / svt::KR_TEAMS), (unsigned)(b % svt::KR_TEAMS),
             [&](unsigned) { svt::keccak_read_kernel(s); });
  FILE* o = fopen(argv[2], "wb");
  fwrite(hash.data(), 4, hash.size(), o);
  fwrite(chal.data(), 4, chal.size(), o);
  fclose(o);
  return 0; }
"""


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    return gxx


def _build(d: Path, main: str, kernel: bool) -> Path:
    (d / "cuda_runtime.h").write_text(RUNTIME_STUB)
    (d / "warp.h").write_text(WARP)
    (d / "keccak.cuh").write_text((CSRC / "keccak.cuh").read_text())
    if kernel:
        (d / "fq.cuh").write_text(FIELD_STUB)
        src = (CSRC / "keccak_kernels.cu").read_text()
        (d / "keccak_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "main.cpp").write_text(main)
    subprocess.run([_gxx(), "-std=c++20", "-O2", "-pthread", "-I", str(d), "-o",
                    str(d / "main"), str(d / "main.cpp")], check=True, capture_output=True,
                   timeout=300)
    return d / "main"


def read_kernel(d: Path):
    """The read kernel built under g++ in `d` -> run(schedule, inst, scalars,
    points, lanes=None) -> (hashes, challenges), (n_sq, B, 8) int32 each;
    `lanes` the (B, l, 2, 8) affine lane points."""
    exe = _build(d, KERNEL, kernel=True)

    def run(schedule, inst, scalars, points, lanes=None):
        rows, starts, pad, pad_starts, consts = (t.numpy() for t in schedule.tables("cpu"))
        B = scalars.shape[0]
        n_sq = len(schedule.squeezes)
        if lanes is None:
            lanes = torch.zeros((B, 0, 2, 8), dtype=torch.int32)
        with open(d / "in.bin", "wb") as f:
            f.write(np.array([B, inst.shape[1], scalars.shape[1], points.shape[1],
                              consts.shape[0], rows.shape[0], n_sq, pad.shape[0],
                              lanes.shape[1]], np.int64).tobytes())
            for a in (inst, consts, scalars, points, rows, starts, pad, pad_starts, lanes):
                f.write(np.ascontiguousarray(a).astype(np.int32).tobytes())
        subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")], check=True,
                       timeout=600)
        out = torch.from_numpy(np.fromfile(d / "out.bin", np.int32).reshape(2, n_sq, B, 8))
        return out[0], out[1]

    return run


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    d = tmp_path_factory.mktemp("keccak_pieces")
    exe = _build(d, PIECES, kernel=False)

    def run(mode, blob: bytes) -> bytes:
        (d / "in.bin").write_bytes(blob)
        subprocess.run([str(exe), mode, str(d / "in.bin"), str(d / "out.bin")], check=True,
                       timeout=300)
        return (d / "out.bin").read_bytes()

    return run


def _int_words(v: int) -> bytes:
    return v.to_bytes(32, "little")


def test_permutation_matches_python(pieces):
    rng = np.random.default_rng(0)
    states = rng.integers(0, 1 << 64, size=(8, 25), dtype=np.uint64)
    states[0] = 0
    got = np.frombuffer(pieces("perm", states.tobytes()), np.uint64).reshape(8, 25)
    for row, g in zip(states, got):
        host = [[int(row[x + 5 * y]) for y in range(5)] for x in range(5)]
        want = _keccak_f(host)
        assert [int(v) for v in g] == [want[x][y] for y in range(5) for x in range(5)]


def test_codec_matches_python(pieces):
    rng = np.random.default_rng(1)
    vals = [0, (1 << 256) - 1, FQ.p - 1] + [int.from_bytes(rng.bytes(32), "little")
                                           for _ in range(29)]
    out = pieces("codec", b"".join(_int_words(v) for v in vals))
    for k, v in enumerate(vals):
        rec = out[k * 64 : (k + 1) * 64]
        # the lanes, as little-endian bytes, are the value's big-endian bytes
        assert rec[:32] == v.to_bytes(32, "big")
        assert int.from_bytes(rec[32:], "little") == v


def _kernel_r2_words():
    """The R^2 table the kernel passes to fe_mul<FR> as the multiplicand."""
    src = (CSRC / "keccak_kernels.cu").read_text()
    body = re.search(r"const uint32_t r2\[FQ_WORDS\] = \{([^}]*)\}", src).group(1)
    return [int(w.strip().rstrip("u"), 16) for w in body.split(",")]


@pytest.mark.parametrize("k", ["0", "r-1", "r", "2r", "5r", "2^256-1", "random"])
def test_challenge_reduction_matches_python(k):
    """fe_mul<FR>(c, R^2, h) as the kernel calls it: the real carry chains,
    no carry dropped for any 256-bit h."""
    r, R = FR.p, 1 << 256
    rng = np.random.default_rng(2)
    h = {"0": 0, "r-1": r - 1, "r": r, "2r": 2 * r, "5r": 5 * r, "2^256-1": R - 1,
         "random": int.from_bytes(rng.bytes(32), "big")}[k]
    r2 = R * R % r
    assert mul_schedule.unwords(_kernel_r2_words()) == r2
    got = mul_schedule.unwords(mul_schedule.fe_mul("fr", _kernel_r2_words(),
                                                   mul_schedule.words(h)))
    m = (-h * r2 * pow(r, -1, R)) % R
    assert got == (h * r2 + m * r) // R  # the Montgomery product, word for word
    assert got % r == h * R % r and got < 2 * r
    # the plain squeeze's reduction is the same function
    hw = limbs_to_words(torch.tensor([(h >> (16 * i)) & 0xFFFF for i in range(16)]))
    plain = FRW.plain("mul", hw, FRW.const("R2", "cpu"))
    assert sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(plain)) == got


def _lazy_words(rng, n, p):
    """(n, 8) words of Montgomery values in [0, 2p], 0, p and 2p among them."""
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(n)]
    vals[:3] = [0, p, 2 * p][: min(n, 3)]
    return torch.tensor(np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                                      "<i4").reshape(n, 8).copy())


@pytest.fixture(scope="module")
def kernel_read(tmp_path_factory):
    return read_kernel(tmp_path_factory.mktemp("keccak_kernel"))


@pytest.fixture(scope="module")
def kernel(kernel_read):
    run = kernel_read

    def squeeze(words, tags):
        n = words.shape[0]
        schedule = kd.ReadSchedule([[(kd.SRC_SCALAR, w, t) for w, t in enumerate(tags)]])
        h, c = run(schedule, torch.zeros((n, 0, 8), dtype=torch.int32), words,
                   torch.zeros((n, 0, 2, 8), dtype=torch.int32))
        return h[0], c[0]

    return squeeze


def _value(row) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row))


@pytest.mark.parametrize("W", range(1, 31))
def test_kernel_body_matches_keccak256_and_plain(kernel, W):
    """W words of all three tags per buffer, 5 buffers: raw words of
    hash size (>= 5r), lazy Fr and Fq Montgomery words."""
    rng = np.random.default_rng(100 + W)
    n = 5
    tags = [int(t) for t in rng.integers(0, 3, size=W)]
    tags[0] = kd.TAG_RAW if W > 1 else int(rng.integers(0, 3))
    cols = []
    for t in tags:
        if t == kd.TAG_RAW:
            raw = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
            raw[0] = (1 << 256) - 1 - int(rng.integers(0, 1 << 20))  # >= 5r
            cols.append(torch.tensor(np.frombuffer(b"".join(v.to_bytes(32, "little")
                                                            for v in raw), "<i4")
                                     .reshape(n, 8).copy()))
        else:
            cols.append(_lazy_words(rng, n, (FR if t == kd.TAG_FR else FQ).p))
    words = torch.stack(cols, 1).contiguous()
    h, c = kernel(words, tags)
    hp, cp = kd.squeeze_plain(words, tags)
    assert torch.equal(h, hp) and torch.equal(c, cp)
    R = 1 << 256
    for b in range(n):
        data = b""
        for w, t in enumerate(tags):
            v = _value(words[b, w])
            if t != kd.TAG_RAW:
                p = (FR if t == kd.TAG_FR else FQ).p
                v = v * pow(R, -1, p) % p
            data += v.to_bytes(32, "big")
        want = keccak256(data + (b"\x01" if W == 1 else b""))
        assert _value(h[b]) == int.from_bytes(want, "big")
        assert _value(c[b]) % FR.p == int.from_bytes(want, "big") * R % FR.p



@pytest.mark.parametrize("W", [32, 33, 40, 64, 70])
def test_kernel_body_long_buffers(kernel, W):
    """Buffers past one chunk of 32 words: the ring of sponge lanes wraps
    (64 and 70 words fill it more than once) and blocks straddle chunks."""
    rng = np.random.default_rng(200 + W)
    n = 2
    tags = [int(t) for t in rng.integers(0, 3, size=W)]
    cols = [_lazy_words(rng, n, (FR if t == kd.TAG_FR else FQ).p) for t in tags]
    words = torch.stack(cols, 1).contiguous()
    h, c = kernel(words, tags)
    hp, cp = kd.squeeze_plain(words, tags)
    assert torch.equal(h, hp) and torch.equal(c, cp)


@pytest.mark.parametrize("n_lanes", [1, 2, 3])
def test_kernel_body_reads_lane_points(kernel_read, n_lanes):
    """Lane-point words (an instance commitment's affine x and y, Fq
    Montgomery words, lazy up to 2q, canonical coordinates at or above q/2
    among them) beside stream points and scalars, in a read of three
    squeezes whose lanes come in column order and out of it: the kernel's
    words equal `read_plain`'s and the python-int transcript's (x then y,
    each big-endian, the dup marker after a lone hash)."""
    rng = np.random.default_rng(300 + n_lanes)
    B = 3
    R = 1 << 256
    lanes = torch.stack([_lazy_words(rng, 2 * n_lanes, FQ.p).reshape(n_lanes, 2, 8)
                         for _ in range(B)], 0).contiguous()
    lanes[1, 0, 0] = torch.tensor(np.frombuffer((FQ.p - 1).to_bytes(32, "little"), "<i4")
                                  .copy())  # a coordinate >= q/2, canonical
    points = torch.stack([_lazy_words(rng, 2, FQ.p).reshape(1, 2, 8) for _ in range(B)], 0)
    scalars = _lazy_words(rng, B, FR.p).reshape(B, 1, 8)
    inst = torch.zeros((B, 0, 8), dtype=torch.int32)
    LX, LY, FQT = kd.SRC_LANE_X, kd.SRC_LANE_Y, kd.TAG_FQ
    first = [(kd.SRC_CONST, 0, kd.TAG_RAW)] + [w for c in range(n_lanes)
                                              for w in ((LX, c, FQT), (LY, c, FQT))]
    second = [(kd.SRC_HASH, 0, kd.TAG_RAW), (kd.SRC_POINT_X, 0, FQT), (kd.SRC_POINT_Y, 0, FQT),
              (LX, n_lanes - 1, FQT), (LY, n_lanes - 1, FQT), (kd.SRC_SCALAR, 0, kd.TAG_FR)]
    sched = kd.ReadSchedule([first, second, [(kd.SRC_HASH, 1, kd.TAG_RAW)]], [7])
    h, c = kernel_read(sched, inst, scalars, points, lanes)
    hp, cp = kd.read_plain(sched, inst, scalars, points, lanes)
    assert torch.equal(h, hp) and torch.equal(c, cp)
    src = {kd.SRC_POINT_X: lambda b, i: points[b, i, 0], kd.SRC_POINT_Y: lambda b, i: points[b, i, 1],
           LX: lambda b, i: lanes[b, i, 0], LY: lambda b, i: lanes[b, i, 1],
           kd.SRC_SCALAR: lambda b, i: scalars[b, i]}
    for b in range(B):
        hashes = []
        for q, sq in enumerate(sched.squeezes):
            data = b""
            for s_, i, t in sq:
                if s_ == kd.SRC_CONST:
                    v = 7
                elif s_ == kd.SRC_HASH:
                    v = hashes[i]
                else:
                    p = FQ.p if t == FQT else FR.p
                    v = _value(src[s_](b, i)) * pow(R, -1, p) % p
                data += v.to_bytes(32, "big")
            hashes.append(int.from_bytes(keccak256(data + (b"\x01" if len(sq) == 1 else b"")),
                                         "big"))
            assert _value(h[q, b]) == hashes[-1]
            assert _value(c[q, b]) % FR.p == hashes[-1] * R % FR.p
    with pytest.raises(ValueError):  # the read takes more lane points than it is given
        kd.read_plain(sched, inst, scalars, points, lanes[:, : n_lanes - 1])
