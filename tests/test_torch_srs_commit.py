"""The host provers' commitments and the SRS writer against the JAX
package:

  * `py_ec.msm` (Pippenger over Jacobian coordinates) and `scalar_mul`
    against the JAX package's affine oracle, identity, zero and r − 1
    scalars, P and −P included;
  * `Srs.commit(..., device="cpu")` equals the JAX `Srs.commit` at n = 0,
    1, 4, 5, 17 and 32 and on an all-zero polynomial (the identity, None);
    more coefficients than powers raise; with no device and no card it
    raises, as `resolve_device` does, and never falls back to the CPU;
  * `lagrange_commitments` of `toy_srs(16)` equals the JAX
    `g_lagrange()`, and `save_params` writes the JAX file byte for byte,
    which `load_params` reads back;
  * `_g2_to_bytes` of G2's generator, [τ]G2 and the identity equals the
    JAX package's, and `g2_from_bytes` inverts it.

Tolerance: exact (python ints, bytes)."""

import dataclasses

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import py_ec as JEC
from snark_verifier_tpu.sdk import srs as jsrs
from snark_verifier_tpu_torch.ec import py_ec
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.sdk import srs as tsrs

R = FR.p


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def test_py_ec_matches_the_jax_oracle():
    pts = JEC.rand_points(12, seed=4)
    P = pts[0]
    for k in (0, 1, 2, 3, R - 1, R, 2**200 + 7):
        assert py_ec.scalar_mul(P, k) == JEC.scalar_mul(P, k)
    assert py_ec.scalar_mul(None, 5) is None
    for n in (0, 1, 2, 3, 5, 12):
        sc = _scalars(n, n)
        assert py_ec.msm(pts[:n], sc) == JEC.msm(pts[:n], sc)
    sc = _scalars(7, 12)
    sc[1], sc[2], sc[3] = 0, R - 1, 1
    assert py_ec.msm(pts, sc) == JEC.msm(pts, sc)
    assert py_ec.msm([P, py_ec.neg(P)], [5, 5]) is None
    assert py_ec.msm([P, P, None], [5, 7, 9]) == JEC.scalar_mul(P, 12)


@pytest.mark.parametrize("n", [0, 1, 4, 5, 17, 32])
def test_commit_on_the_cpu_matches_jax(n):
    srs, jsrs_ = tsrs.toy_srs(32), jsrs.toy_srs(32)
    c = _scalars(100 + n, n)
    got = srs.commit(c, device="cpu")
    assert got == jsrs_.commit(c)
    assert got is None if n == 0 else all(type(v) is int for v in got)


def test_commit_of_zero_is_the_identity():
    srs, jsrs_ = tsrs.toy_srs(32), jsrs.toy_srs(32)
    assert srs.commit([0] * 7, device="cpu") is None
    assert jsrs_.commit([0] * 7) is None


def test_commit_refuses_a_long_polynomial_and_a_missing_card(monkeypatch):
    srs = tsrs.toy_srs(32)
    with pytest.raises(ValueError):
        srs.commit([1] * 33, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srs.commit([1, 2, 3])


def test_save_params_is_the_jax_file(tmp_path):
    srs = dataclasses.replace(tsrs.toy_srs(16), g_lagrange=[])  # the cached one stays as it is
    jsrs_ = jsrs.toy_srs(16)
    assert srs.g_lagrange == []
    lag = srs.lagrange_commitments()
    assert lag == jsrs_.g_lagrange() and srs.g_lagrange is lag
    tsrs.save_params(srs, tmp_path / "port.bin")
    jsrs.save_params(jsrs_, str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    back = tsrs.load_params(str(tmp_path / "port.bin"))
    assert back.g1_powers == srs.g1_powers and back.g_lagrange == lag
    assert (back.g2, back.s_g2) == (srs.g2, srs.s_g2)
    with pytest.raises(ValueError):
        tsrs.Srs(srs.g1_powers, srs.g2, srs.s_g2).lagrange_commitments()


def test_g2_bytes_match_jax():
    srs = tsrs.toy_srs(16)
    for pt in (srs.g2, srs.s_g2, None):
        b = tsrs._g2_to_bytes(pt)
        assert b == jsrs._g2_to_bytes(pt)
        assert tsrs.g2_from_bytes(b) == pt
