"""The inversion of `svt_field_inv` (csrc/fe_inv.cuh), run on the host.

csrc/fe_inv.cuh is free of inline PTX, so g++ compiles that very text: a
variable-time binary extended GCD (Pornin's optimized binary GCD, 30 steps
a round on 62-bit approximations, then a 2x2 update of the 256-bit values),
returning the canonical Montgomery inverse.  Held, in Fq and Fr, against

* python ints: for a Montgomery word x = A R in [0, 2p], the kernel returns
  A^-1 R = x^(p-2) R^2 mod p, canonical, and 0 for 0;
* the JAX package's `LimbField.inv` (Fermat, a lax.scan) on the same words,
  after `canon`;

on 0, 1, p - 1, p, 2p - 1, 2p, lazy words in [p, 2p), inputs whose
approximated comparisons go wrong (a round's a' or b' comes out negative and
is negated) and >= 1,000 seeded words in [0, 2p).  Every inversion takes at
most Pornin's bound of 17 rounds.  Skips inside the test where no g++ is
found.

Tolerance: exact."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from snark_verifier_tpu.ff import FQ_FIELD as JFQ
from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu_torch.ff.spec import FQ, FR

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
R = 1 << 256
PORNIN_ROUNDS = 17  # ceil((2 * 254 - 1) / 30)

# Reads (field, 8 words) records; writes (8 words, rounds) records.
MAIN = r"""
#include <cstdio>
#include "fe_inv.cuh"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  uint32_t rec[9];
  while (fread(rec, 4, 9, f) == 9) {
    uint32_t r[8];
    const int rounds = rec[0] ? svt::fe_inv_gcd<1>(r, rec + 1) : svt::fe_inv_gcd<0>(r, rec + 1);
    fwrite(r, 4, 8, o);
    fwrite(&rounds, 4, 1, o);
  }
  fclose(o);
  return 0; }
"""

# Inputs (canonical y; x = y or y + p) on which an approximated comparison
# goes wrong in some round, a' (the first two) or b' (the last two) coming
# out negative, found by a python model of the same rounds.
NEGATING = {
    "fq": [0x67649dc3bc5134daf332943ae229a97b27b0919232fb6bc5d8e6462d5bb227d,
           0x11b39715da2ab37dc9b0f3e4372092015e5a659bb657a9fc748e2331ca406caa,
           0x29d361e47f9354d136d9a786c66ac09d157ca506373267a8968612ef394013f,
           0x10a90b9b4b6ba64f990501b7410a010ea5cb3fb62ef955b15b04ec14cb201718],
    "fr": [0x1c6f0178ee102209ece8bd7dea9a5b1f57f8638614a684f4151dbe169f8bf626,
           0x162739404225c8d89657e5280244de5da1170e312ea10f152af0f3e832436bed,
           0x2985950d6a438a320177e5005bf48c9022c32cb6fa84b6bb524574e9a6814fb0,
           0x12dce431b37d2dad4c0d72dc95f5c6907e6af790eed3fe956a199f0f82ce8c02],
}


@pytest.fixture(scope="module")
def inv_gcd(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the inversion's C++ on the host")
    d = tmp_path_factory.mktemp("inv_gcd")
    (d / "main.cpp").write_text(MAIN)
    exe = d / "main"
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(CSRC), "-o", str(exe),
                    str(d / "main.cpp")], check=True, capture_output=True, timeout=300)

    def run(field: int, xs):
        rec = np.zeros((len(xs), 9), np.uint32)
        rec[:, 0] = field
        for k, x in enumerate(xs):
            rec[k, 1:] = [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        (d / "in.bin").write_bytes(rec.tobytes())
        subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")], check=True,
                       timeout=300)
        out = np.fromfile(d / "out.bin", np.uint32).reshape(len(xs), 9)
        vals = [sum(int(w) << (32 * i) for i, w in enumerate(row[:8])) for row in out]
        return vals, [int(r) for r in out[:, 8]]

    return run


def _inputs(name: str, p: int):
    rng = np.random.default_rng(0xC0DE + (name == "fr"))
    xs = [0, 1, p - 1, p, 2 * p - 1, 2 * p, p + 1, 2, 1 << 200, R * R % p, R % p]
    xs += [y + p * int(rng.integers(0, 2)) for y in NEGATING[name]]
    xs += [p + int.from_bytes(rng.bytes(32), "little") % p for _ in range(64)]  # lazy, >= p
    xs += [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(1024)]
    xs += [int(rng.integers(1, 1 << 62)) << int(rng.integers(0, 190)) for _ in range(32)]
    return [x % (2 * p + 1) for x in xs]


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_inversion_matches_python_ints(inv_gcd, name):
    p = (FQ if name == "fq" else FR).p
    xs = _inputs(name, p)
    got, rounds = inv_gcd(0 if name == "fq" else 1, xs)
    for x, g in zip(xs, got):
        assert g == pow(x, p - 2, p) * R * R % p, hex(x)  # x = A R -> A^-1 R, canonical
        assert g < p
    assert got[0] == 0 and got[3] == 0 and got[5] == 0  # 0, p and 2p map to 0
    assert max(rounds) <= PORNIN_ROUNDS
    assert 9 <= sorted(rounds)[len(rounds) // 2] <= 13  # ~12 rounds on random inputs


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_inversion_matches_jax_limb_field_after_canon(inv_gcd, name):
    from snark_verifier_tpu.ff.spec import int_to_limbs, limbs_to_int

    p = (FQ if name == "fq" else FR).p
    F = JFQ if name == "fq" else JFR
    xs = _inputs(name, p)
    got, _ = inv_gcd(0 if name == "fq" else 1, xs)
    want = np.asarray(F.canon(F.inv(np.stack([int_to_limbs(x) for x in xs]))))
    assert got == [limbs_to_int(row) for row in want]
