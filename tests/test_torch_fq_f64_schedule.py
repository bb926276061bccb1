"""The FP64-limb Montgomery multiply of csrc/fq_f64.cuh (route 1 of
`svt_fq_mul_chain`), its own text run on the host: a schedule twin.

g++ (C++20, `-ffp-contract=off -frounding-math`) compiles fq_f64.cuh through
a shim of the CUDA intrinsics it uses: `__fma_rn` is `std::fma`, `__fma_rz`
is `std::fma` under `FE_TOWARDZERO`, `__dsub_rn` / `__dadd_rn` plain
subtraction and addition, and the reinterpretations `std::bit_cast`.  The header's `SVT_F64_OBSERVE`
hook records the largest value each column reached.  Checked against
python ints:

* the exact split of a limb product into its 52-bit halves, on the worst
  products and on ones whose fraction rounds up to nearest (which toward
  zero must not);
* the R' = 2^260 product (ab + m p) / R' and the dedicated square, exactly,
  on every pair of the edge values 0, 1, p - 1, p, 2p - 1, 2p and the
  largest value in [0, 2p] whose four low limbs are all 2^52 - 1, and on
  10^4 drawn pairs of lazy values;
* the conversion of the port's words to limbs and doubles and back;
* CH = 16 chains of products and of squares (both square forms) from lazy
  inputs, equal to `fq_mul_chain_plain` / `fq_sqr_chain_plain` after
  `canon`, and CH = 0;
* the column bound: no column passes the header's F64_COLUMN_BOUND (< 2^57)
  on any of these inputs; on the worst ones (all-ones limbs) each column's
  largest value is that of a python model of the same schedule.

Skips inside each test where no g++ is found.  Tolerance: exact."""

import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch.ec import words_to_limbs
from snark_verifier_tpu_torch.ff import FQ_FIELD
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.msm import cuda_ops

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
P = FQ.p
R2 = 1 << 260
MASK = (1 << 52) - 1
PINV = -pow(P, -1, R2) % R2
CH = 16

# The CUDA intrinsics fq_f64.cuh uses, on the host (the fold test reuses
# them).
INTRINSICS = r"""
#include <bit>
#include <cfenv>
#include <cmath>
#include <cstdint>
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
// Toward zero: the operands are read and the result written through
// volatiles, so the fma cannot move out of the rounding mode.
inline double __fma_rz(double a, double b, double c) {
  volatile double va = a, vb = b, vc = c, r;
  std::fesetround(FE_TOWARDZERO);
  r = std::fma(va, vb, vc);
  std::fesetround(FE_TONEAREST);
  return r; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline long long __double_as_longlong(double x) { return std::bit_cast<long long>(x); }
inline double __longlong_as_double(long long x) { return std::bit_cast<double>(x); }
"""

SHIM = r"""
#pragma once
#define __host__
#define __device__
#define __forceinline__ inline
""" + INTRINSICS + r"""
extern uint64_t svt_column_max[10];
#define SVT_F64_OBSERVE(k, v) \
  do { if ((v) > svt_column_max[k]) svt_column_max[k] = (v); } while (0)
"""

# Reads (mode, n, ch) and n records; writes n results, then the columns'
# largest values.  Modes: 0 the product of limbs, 1 the dedicated square,
# 2 the split of a limb product (hi, lo halves), 3 words -> limbs, doubles
# (as integers) and words again, 4 the multiply chain on words, 5 and 6 the
# square chain (dedicated, the product by itself).
HARNESS = r"""
#include <cstdio>
#include <vector>
#include "shim.h"
#include "fq_f64.cuh"
uint64_t svt_column_max[10];
using namespace svt;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[3];
  if (fread(h, 8, 3, f) != 3) return 2;
  const long long mode = h[0], n = h[1];
  const int ch = (int)h[2];
  std::vector<uint64_t> out;
  for (long long r = 0; r < n; r++) {
    if (mode <= 1) {
      uint64_t al[5], bl[5], rl[5];
      double a[5], b[5];
      if (fread(al, 8, 5, f) != 5 || fread(bl, 8, 5, f) != 5) return 3;
      f64_from_limbs(a, al);
      f64_from_limbs(b, bl);
      if (mode == 0) f64_mul(rl, a, b); else f64_sqr(rl, a);
      out.insert(out.end(), rl, rl + 5);
    } else if (mode == 2) {
      uint64_t ab[2], c[2] = {0, 0};
      if (fread(ab, 8, 2, f) != 2) return 3;
      f64_split_add(c[0], c[1], f64_of(ab[0]), f64_of(ab[1]));
      out.push_back(c[1] - F64_BITS_2P104);
      out.push_back(c[0] - F64_BITS_2P52);
    } else if (mode == 3) {
      uint32_t w[8], back[8];
      uint64_t l[5];
      double d[5];
      if (fread(w, 4, 8, f) != 8) return 3;
      f64_limbs_from_words(l, w);
      f64_from_limbs(d, l);
      f64_words_from_limbs(back, l);
      for (int i = 0; i < 5; i++) out.push_back(l[i]);
      for (int i = 0; i < 5; i++) out.push_back((uint64_t)d[i]);
      for (int i = 0; i < 8; i++) out.push_back(back[i]);
    } else {
      uint32_t x[8], y[8], o[8];
      if (fread(x, 4, 8, f) != 8 || fread(y, 4, 8, f) != 8) return 3;
      if (mode == 4) f64_mul_chain(o, x, y, ch);
      else if (mode == 5) f64_sqr_chain<true>(o, x, ch);
      else f64_sqr_chain<false>(o, x, ch);
      out.insert(out.end(), o, o + 8);
    }
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 8, out.size(), o);
  fwrite(svt_column_max, 8, 10, o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the header's C++ on the host")
    d = tmp_path_factory.mktemp("fq_f64_schedule")
    (d / "shim.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    shutil.copy(CSRC / "fq_f64.cuh", d / "fq_f64.cuh")
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-frounding-math", "-I",
                    str(d), "-o", str(d / "harness"), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)

    def run(mode, records, width, ch=0):
        """records: n rows of 64-bit limbs (modes 0-2) or 32-bit words (3-6)
        -> (n, width) uint64 results and the columns' largest values."""
        records = np.ascontiguousarray(records, dtype=np.uint64 if mode <= 2 else np.uint32)
        n = records.shape[0]
        inp, out = d / f"in{mode}.bin", d / f"out{mode}.bin"
        with open(inp, "wb") as f:
            f.write(np.array([mode, n, ch], np.int64).tobytes())
            f.write(records.tobytes())
        r = subprocess.run([str(d / "harness"), str(inp), str(out)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, (r.returncode, r.stderr)
        got = np.fromfile(out, np.uint64)
        return got[:-10].reshape(n, width), [int(v) for v in got[-10:]]

    return run


def _limbs(v):
    return [(v >> (52 * i)) & MASK for i in range(5)]


def _value(row):
    return sum(int(x) << (52 * i) for i, x in enumerate(row))


def _mont(a, b):
    """(ab + m p) / 2^260 with m = ab (-p^-1) mod 2^260: the header's
    product exactly."""
    t = a * b
    m = t * PINV % R2
    assert (t + m * P) % R2 == 0
    return (t + m * P) >> 260


def _edges():
    top = (2 * P) >> 208
    low_ones = (1 << 208) - 1
    ones = top << 208 | low_ones
    if ones > 2 * P:
        ones = (top - 1) << 208 | low_ones
    assert ones <= 2 * P and all(x == MASK for x in _limbs(ones)[:4])
    return [0, 1, P - 1, P, 2 * P - 1, 2 * P, ones]


def _bound():
    """F64_COLUMN_BOUND as the header states it."""
    text = (CSRC / "fq_f64.cuh").read_text()
    m = re.search(r"F64_COLUMN_BOUND = (\d+) \* F64_MASK \+ (\d+);", text)
    return int(m.group(1)) * MASK + int(m.group(2))


def test_split_is_exact(harness):
    """hi = floor(ab / 2^52), lo = ab mod 2^52 for the largest limbs, for
    products whose fraction is at or above one half (rounding to nearest
    would give hi + 1) and for random limbs."""
    rng = random.Random(1)
    pairs = [(MASK, MASK), (MASK, 1 << 51 | 1), (MASK, 3), (MASK, 2), (0, MASK), (1, 1),
             ((1 << 52) - 3, (1 << 51) + 7)]
    pairs += [(rng.getrandbits(52), rng.getrandbits(52)) for _ in range(2000)]
    assert any((a * b) % (1 << 52) >= 1 << 51 for a, b in pairs[:3])
    got, _ = harness(2, np.array(pairs, np.uint64), 2)
    for (a, b), (hi, lo) in zip(pairs, got):
        assert (int(hi), int(lo)) == divmod(a * b, 1 << 52), (a, b)


@pytest.mark.parametrize("square", [False, True], ids=["mul", "square"])
def test_product_on_edges_and_drawn_pairs(harness, square):
    """The R' product (and the dedicated square on a = b) equals
    (ab + m p) / 2^260 exactly, lies in [0, 2p), and no column passes the
    stated bound."""
    rng = random.Random(2 + square)
    edges = _edges()
    pairs = [(a, b) for a in edges for b in edges]
    pairs += [(rng.randrange(2 * P + 1), rng.randrange(2 * P + 1)) for _ in range(10_000)]
    if square:
        pairs = [(a, a) for a in edges] + [(a, a) for a, _ in pairs[len(edges) ** 2:]]
    rec = np.array([_limbs(a) + _limbs(b) for a, b in pairs], np.uint64)
    got, cols = harness(1 if square else 0, rec, 5)
    for (a, b), row in zip(pairs, got):
        want = _mont(a, b)
        assert want < 2 * P
        assert _value(row) == want and all(int(x) <= MASK for x in row), (a, b)
    assert max(cols) <= _bound() < 1 << 57


def _columns(a, b, square=False):
    """The header's column schedule in python ints: each column's value when
    complete (the values SVT_F64_OBSERVE sees)."""
    al, bl, pl = _limbs(a), _limbs(b), _limbs(P)
    pinv52 = PINV & MASK
    c, seen = [0] * 10, [0] * 10

    def halves(k, t):
        c[k] += t & MASK
        c[k + 1] += t >> 52

    def row(i):
        seen[i] = c[i]
        m = c[i] * pinv52 & MASK
        c[i + 1] += (m * pl[0] >> 52) + ((c[i] + MASK) >> 52)
        for j in range(1, 5):
            halves(i + j, m * pl[j])

    if square:
        for i in range(5):
            for j in range(i + 1, 5):
                halves(i + j, al[i] * al[j])
        c = [2 * v for v in c]
        for i in range(5):
            halves(2 * i, al[i] * al[i])
        for i in range(5):
            row(i)
    else:
        for i in range(5):
            for j in range(5):
                halves(i + j, al[i] * bl[j])
            row(i)
    for k in range(5, 10):
        seen[k] = c[k]
        if k < 9:
            c[k + 1] += c[k] >> 52
    return seen


@pytest.mark.parametrize("square", [False, True], ids=["mul", "square"])
def test_worst_columns_within_the_stated_bound(harness, square):
    """Operands of all-ones limbs (2^260 - 1, the fullest columns) and the
    largest lazy value with all-ones low limbs: each column's largest value
    is the python model's of the same schedule, and below the header's
    F64_COLUMN_BOUND (< 2^57)."""
    ones = (1 << 260) - 1
    for a in (ones, _edges()[-1]):
        got, cols = harness(1 if square else 0, np.array([_limbs(a) + _limbs(a)], np.uint64), 5)
        assert _value(got[0]) == _mont(a, a)
        assert cols == _columns(a, a, square)
        assert max(cols) <= _bound() < 1 << 57
    # the header's derivation: at most 18 halves (or doubled equivalents) a
    # column, each below 2^52, and a carry of at most 19
    ab = [sum((i + j == k) + (i + j + 1 == k) for i in range(5) for j in range(5))
          for k in range(10)]
    if square:
        ab = [sum(2 * ((i + j == k) + (i + j + 1 == k)) for i in range(5) for j in range(i + 1, 5))
              + sum((2 * i == k) + (2 * i + 1 == k) for i in range(5)) for k in range(10)]
    mp = [sum((i + j == k and j >= 1) + (i + j + 1 == k) for i in range(5) for j in range(5))
          for k in range(10)]
    assert max(x + y for x, y in zip(ab, mp)) == 18
    assert _bound() == 18 * MASK + 19


def _words(vals):
    """python ints below 2^256 -> (n, 8) uint32 words as uint64 records."""
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in vals], np.uint64)


def test_word_conversion_round_trip(harness):
    """words -> 52-bit limbs -> exact doubles, and limbs -> the same words."""
    rng = random.Random(4)
    vals = _edges() + [(1 << 256) - 1] + [rng.getrandbits(256) for _ in range(500)]
    got, _ = harness(3, _words(vals), 18)
    for v, row in zip(vals, got):
        assert [int(x) for x in row[:5]] == _limbs(v)
        assert [int(x) for x in row[5:10]] == _limbs(v)
        assert _value(row[:5]) == v
        assert [int(x) for x in row[10:]] == [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def _lazy(n, seed):
    """n lazy Fq values in [0, 2p] with the edges first: (n, 8) int32 words."""
    rng = random.Random(seed)
    vals = (_edges() + [rng.randrange(2 * P + 1) for _ in range(n)])[:n]
    w = _words(vals).astype(np.uint32).view(np.int32)
    return torch.from_numpy(w.copy()), vals


def _canon(words):
    return FQ_FIELD.canon(words_to_limbs(words))


@pytest.mark.parametrize("mode", [4, 5, 6], ids=["mul", "square-dedicated", "square-by-mul"])
@pytest.mark.parametrize("ch", [CH, 0])
def test_chain_equals_plain_after_canon(harness, mode, ch):
    """The chain on the port's words: canonical output, equal to CH steps of
    the plain version after `canon`."""
    x, _ = _lazy(300, 10 + mode)
    y, _ = _lazy(300, 20 + mode)
    y = y.flip(0).contiguous()
    rec = np.concatenate([x.numpy().view(np.uint32), y.numpy().view(np.uint32)], 1)
    got, cols = harness(mode, rec, 8, ch)
    got = torch.from_numpy(got.astype(np.uint32).view(np.int32).copy())
    want = (cuda_ops.fq_mul_chain_plain(x, y, ch) if mode == 4
            else cuda_ops.fq_sqr_chain_plain(x, ch))
    assert torch.equal(words_to_limbs(got), _canon(got)), "a word at or above p"
    assert torch.equal(_canon(got), _canon(want))
    assert max(cols) <= _bound()
