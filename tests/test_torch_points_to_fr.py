"""`svt_points_to_fr` (ff/word_field.py::points_to_fr, csrc/field_kernels.cu):
the Poseidon transcript's Fq -> Fr map, and in projective mode the fold's
affine normalisation before it, against the JAX package.

* Affine mode: `points_to_fr_plain` equals JAX `fq_to_fr` word for word
  (after the limb/word codec) on lazy Fq words in [0, 2q]: 0, 1, r - 1, r,
  q - 1, q, 2q and seeded words, values at and above r among them.
* Projective mode: it equals JAX `fq_to_fr(G1.to_affine(.))` on projective
  points with Z = 1, with random Z, and on identity lanes with Z = 0, p and
  2p (as lazy words) under random X and Y.
* Projective mode with `map_fr=False` (the keccak read's instance
  commitments): canonical affine Fq words equal to JAX `G1.to_affine`
  after `canon`, (0, 0) for the identity lanes, and to the canon of
  `cuda_ops.affine_xy`; mapped, they give the projective mode's words.
* `PoseidonTranscript.absorb_projective_points` squeezes what JAX
  `absorb_ec_points_scanned` squeezes after `G1.to_affine`, and what the
  port's affine absorb squeezes after `cuda_ops.affine_xy`.
* The kernel's own C++ runs on the host (g++, the launch syntax stripped, a
  stub of the CUDA runtime, the portable stand-in for csrc/fq.cuh's field
  functions of tests/test_torch_fr_tape_schedule.py and the real
  csrc/fe_inv.cuh), thread by thread in both modes, against the plain
  version, in all three modes.  Skips inside that test where no g++ is
  found.

Inputs are made with numpy from a seed.  Tolerance: exact, word for word."""

import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_fr_tape_schedule as schedule
import torch

from snark_verifier_tpu.ec.g1 import G1 as JG1
from snark_verifier_tpu.ec import py_ec as jpy_ec
from snark_verifier_tpu.ff import FQ_FIELD as JFQ
from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.transcript import PoseidonTranscript as JPoseidonTranscript
from snark_verifier_tpu.transcript.poseidon_transcript import fq_to_fr as j_fq_to_fr
from snark_verifier_tpu_torch.ff import (
    FQ,
    FQW,
    FR,
    FRW,
    limbs_to_words,
    points_to_fr,
    points_to_fr_plain,
    to_jax_elems,
    words_to_limbs,
)
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.pcs.kzg.accumulation import fold_transcript
from snark_verifier_tpu_torch.transcript import fq_to_fr

CSRC = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
R = 1 << 256
Q = FQ.p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(vals):
    """python ints (raw words, < 2^256) -> (n, 8) int32 words."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(len(vals), 16)))


def _ints(words):
    """(..., 8) int32 words -> nested python ints (raw words)."""
    w = words.reshape(-1, 8).tolist()
    return [sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(row)) for row in w]


def _lazy_fq(rng, n):
    vals = [0, 1, FR.p - 1, FR.p, Q - 1, Q, 2 * Q, Q + 1, FR.p + 12345]
    vals += [int.from_bytes(rng.bytes(32), "little") % (2 * Q + 1) for _ in range(n)]
    return vals


def _projective(rng):
    """(n, 3, 8) Montgomery words and the affine int points (None for the
    identity): Z = 1, random Z, and identities with Z = 0, p, 2p as raw
    words under random X and Y."""
    pts = [jpy_ec.scalar_mul(jpy_ec.G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(12)]
    rows, want = [], []
    for k, (x, y) in enumerate(pts):
        lam = 1 if k < 4 else int.from_bytes(rng.bytes(32), "little") % (Q - 1) + 1
        coords = [x * lam % Q, y * lam % Q, lam]
        raw = [c * R % Q for c in coords]
        if k % 3 == 2:  # a lazy representative, value + q, where it stays below 2q
            raw = [c + Q if c < Q else c for c in raw]
        rows.append(raw)
        want.append((x, y))
    for z in (0, Q, 2 * Q):
        xr, yr = (int.from_bytes(rng.bytes(32), "little") % (2 * Q + 1) for _ in range(2))
        rows.append([xr, yr, z])
        want.append(None)
    words = _words([c for row in rows for c in row]).reshape(len(rows), 3, 8)
    return words, want


def test_affine_plain_matches_jax_fq_to_fr():
    x = _words(_lazy_fq(np.random.default_rng(1), 256))
    got = points_to_fr_plain(x)
    want = np.asarray(jax.jit(j_fq_to_fr)(jnp.asarray(to_jax_elems(x))))
    assert np.array_equal(to_jax_elems(got), want)
    assert torch.equal(fq_to_fr(x), got) and torch.equal(points_to_fr(x), got)
    vals = _ints(x)
    assert [v % (2 * FR.p + 1) for v in _ints(got)] == _ints(got)  # lazy Fr words
    assert FRW.to_int(got).tolist() == [v * pow(R, -1, Q) % Q % FR.p for v in vals]


def test_affine_plain_keeps_leading_axes():
    x = _words(_lazy_fq(np.random.default_rng(2), 3 * 5 * 2 - 9)).reshape(3, 5, 2, 8)
    got = points_to_fr(x)
    assert got.shape == (3, 5, 2, 8)
    assert torch.equal(got.reshape(-1, 8), points_to_fr_plain(x.reshape(-1, 8)))


def test_projective_plain_matches_jax_to_affine_then_fq_to_fr():
    pts, want = _projective(np.random.default_rng(3))

    def jax_map(p):
        x, y, _ = JG1.to_affine(p)
        return jnp.stack([j_fq_to_fr(x), j_fq_to_fr(y)], -2)

    got = points_to_fr(pts, projective=True)
    assert got.shape == (pts.shape[0], 2, 8)
    assert torch.equal(got, points_to_fr_plain(pts, projective=True))
    ref = np.asarray(jax.jit(jax_map)(jnp.asarray(to_jax_elems(pts))))
    assert np.array_equal(to_jax_elems(got), ref)
    gi = FRW.to_int(got.reshape(-1, 8)).tolist()
    for k, w in enumerate(want):
        assert gi[2 * k : 2 * k + 2] == ([0, 0] if w is None else [w[0] % FR.p, w[1] % FR.p])
    # the same as the affine normalisation, then the affine map
    assert torch.equal(got, points_to_fr(cuda_ops.affine_xy(pts)))


def test_projective_to_affine_plain_matches_jax_to_affine():
    pts, want = _projective(np.random.default_rng(8))

    def jax_affine(p):
        x, y, _ = JG1.to_affine(p)
        return jnp.stack([JFQ.canon(x), JFQ.canon(y)], -2)

    got = points_to_fr(pts, projective=True, map_fr=False)
    assert got.shape == (pts.shape[0], 2, 8)
    assert torch.equal(got, points_to_fr_plain(pts, projective=True, map_fr=False))
    ref = np.asarray(jax.jit(jax_affine)(jnp.asarray(to_jax_elems(pts))))
    assert np.array_equal(to_jax_elems(got), ref)
    assert all(v < Q for v in _ints(got))  # canonical Montgomery words
    gi = FQW.to_int(got.reshape(-1, 8)).tolist()
    for k, w in enumerate(want):
        assert gi[2 * k : 2 * k + 2] == ([0, 0] if w is None else list(w))
    assert torch.equal(got, FQW.canon(cuda_ops.affine_xy(pts)))
    assert torch.equal(points_to_fr(got), points_to_fr(pts, projective=True))
    with pytest.raises(ValueError):
        points_to_fr(pts[:, 0], map_fr=False)  # affine mode has no normalisation


def test_projective_absorb_matches_jax_scanned_absorb():
    pts, _ = _projective(np.random.default_rng(4))
    stack = torch.stack([pts, pts.flip(0)], 0).contiguous()  # (2, M, 3, 8): two transcripts

    def jax_squeeze(p):
        t = JPoseidonTranscript(batch_shape=(2,))
        x, y, _ = JG1.to_affine(jnp.moveaxis(p, 1, 0))  # (M, 2, 16)
        t.absorb_ec_points_scanned(jnp.stack([x, y], -2))
        return t.squeeze_challenge()

    want = np.asarray(JFR.to_int(jax.jit(jax_squeeze)(jnp.asarray(to_jax_elems(stack)))))
    t = fold_transcript(2, "cpu")
    t.absorb_projective_points(stack)
    got = t.squeeze_challenge()
    assert FRW.to_int(got).tolist() == [int(v) for v in want]
    t2 = fold_transcript(2, "cpu")
    t2.absorb_ec_points(cuda_ops.affine_xy(stack))
    assert torch.equal(t2.squeeze_challenge(), got)


def test_wrapper_refuses():
    x = _words([1, 2, 3])
    with pytest.raises(ValueError):
        points_to_fr(x.reshape(1, 3, 8)[:, :2], projective=True)  # not (..., 3, 8)
    with pytest.raises(ValueError):
        points_to_fr(x.reshape(3, 8)[:, :4])
    with pytest.raises(TypeError):
        points_to_fr(x.long())
    with pytest.raises(TypeError):
        points_to_fr(words_to_limbs(x).numpy())


HARNESS = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
dim3_ threadIdx, blockIdx;
#include "field_kernels.cpp"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[2];
  if (fread(h, 8, 2, f) != 2) return 2;
  const long long mode = h[0], n = h[1], projective = mode != 0;
  const long long in_words = n * (projective ? 24 : 8), out_words = n * (projective ? 16 : 8);
  std::vector<uint32_t> in(in_words), out(out_words);
  if (fread(in.data(), 4, in_words, f) != (size_t)in_words) return 3;
  const long long T = projective ? svt::INV_THREADS : svt::FE_THREADS;
  for (long long i = 0; i < n; i++) {
    blockIdx.x = (unsigned)(i / T); threadIdx.x = (unsigned)(i % T);
    if (mode == 1)
      svt::points_to_fr_projective_kernel<true>(in.data(), out.data(), n);
    else if (mode == 2)
      svt::points_to_fr_projective_kernel<false>(in.data(), out.data(), n);
    else
      svt::points_to_fr_affine_kernel(in.data(), out.data(), n);
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out_words, o);
  fclose(o);
  return 0; }
"""


@pytest.fixture(scope="module")
def kernel_body(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernel's C++ on the host")
    d = tmp_path_factory.mktemp("points_to_fr")
    (d / "cuda_runtime.h").write_text(schedule.RUNTIME_STUB)
    (d / "fq.cuh").write_text(schedule.FIELD_STUB)
    (d / "fe_inv.cuh").write_text((CSRC / "fe_inv.cuh").read_text())
    src = (CSRC / "field_kernels.cu").read_text()
    (d / "field_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(d), "-o", str(d / "h"),
                    str(d / "harness.cpp")], check=True, capture_output=True, timeout=300)

    def run(x, projective, map_fr=True):
        n = x.numel() // (24 if projective else 8)
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([0 if not projective else 1 if map_fr else 2, n],
                             np.int64).tobytes())
            f.write(x.contiguous().numpy().tobytes())
        subprocess.run([str(d / "h"), str(inp), str(out)], check=True, timeout=300)
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(n, *((2, 8) if projective
                                                                      else (8,))))

    return run


def test_kernel_body_matches_plain_in_both_modes(kernel_body):
    x = _words(_lazy_fq(np.random.default_rng(5), 300))  # more than one 256-thread block
    assert torch.equal(kernel_body(x, False), points_to_fr_plain(x))
    pts, _ = _projective(np.random.default_rng(6))
    more = cuda_ops.identity((20,), "cpu")  # (0, 1, 0) words, past a 32-thread block
    rng = np.random.default_rng(7)
    rand = _words([int.from_bytes(rng.bytes(32), "little") % (2 * Q + 1) for _ in range(60)])
    pts = torch.cat([pts, more, rand.reshape(20, 3, 8)]).contiguous()
    got = kernel_body(pts, True)
    assert torch.equal(got, points_to_fr_plain(pts, projective=True))
    assert not bool(got[len(got) - 40 : len(got) - 20].any())  # the identities map to (0, 0)
    aff = kernel_body(pts, True, map_fr=False)
    assert torch.equal(aff, points_to_fr_plain(pts, projective=True, map_fr=False))
    assert not bool(aff[len(aff) - 40 : len(aff) - 20].any())
