"""The port's host polynomial arithmetic (`utils/py_poly.py`) and
`Domain.bn254` against the JAX package's, on numpy-seeded inputs: every
function of the module (trim, padd, psub, pscale, pmul, peval, pdiv_linear,
vanishing, pdivmod, ntt, intt, pmul_ntt on both sides of its schoolbook
cut, pdiv_vanishing, lagrange_interpolate, rand_poly), and the 2-adic
domains k = 0..12 and 28.

Tolerance: exact (python ints)."""

import random

import numpy as np
import pytest

from snark_verifier_tpu.utils import py_poly as J
from snark_verifier_tpu.verifier.plonk.protocol import Domain as JDomain
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.utils import py_poly as P
from snark_verifier_tpu_torch.verifier.plonk.protocol import Domain

R = FR.p


def _poly(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


@pytest.mark.parametrize("na,nb", [(0, 3), (1, 1), (5, 3), (8, 13)])
def test_arithmetic_matches_jax(na, nb):
    rng = np.random.default_rng(100 * na + nb)
    a, b = _poly(rng, na), _poly(rng, nb)
    k, x = _poly(rng, 2)
    assert P.padd(a, b) == J.padd(a, b)
    assert P.psub(a, b) == J.psub(a, b)
    assert P.pscale(a, k) == J.pscale(a, k)
    assert P.pmul(a, b) == J.pmul(a, b)
    assert P.peval(b, x) == J.peval(b, x)
    assert P.trim(a + [0, R]) == J.trim(a + [0, R])
    if b and b[-1]:
        assert P.pdivmod(a, b) == J.pdivmod(a, b)


def test_division_and_interpolation_match_jax():
    rng = np.random.default_rng(1)
    f = _poly(rng, 9)
    z = _poly(rng, 1)[0]
    g = P.psub(f, [P.peval(f, z)])
    assert P.pdiv_linear(g, z) == J.pdiv_linear(g, z)
    with pytest.raises(AssertionError):
        P.pdiv_linear(P.padd(g, [1]), z)
    zs = _poly(rng, 4)
    assert P.vanishing(zs) == J.vanishing(zs)
    assert all(P.peval(P.vanishing(zs), x) == 0 for x in zs)
    pts = list(zip(zs, _poly(rng, 4)))
    lag = P.lagrange_interpolate(pts)
    assert lag == J.lagrange_interpolate(pts)
    assert [P.peval(lag, x) for x, _ in pts] == [y for _, y in pts]
    num = _poly(rng, 40)
    assert P.pdiv_vanishing(num, 16) == J.pdiv_vanishing(num, 16)
    assert P.rand_poly(6, random.Random(3)) == J.rand_poly(6, random.Random(3))


@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_ntt_matches_jax(k):
    rng = np.random.default_rng(k)
    a = _poly(rng, 1 << k)
    w = Domain.bn254(k).gen
    assert P.ntt(a, w) == J.ntt(a, w)
    assert P.intt(a, w) == J.intt(a, w)
    assert P.intt(P.ntt(a, w), w) == a
    assert P.ntt(a, w) == [P.peval(a, pow(w, i, R)) for i in range(1 << k)]


@pytest.mark.parametrize("na,nb", [(20, 30), (40, 60), (100, 3)])
def test_pmul_ntt_matches_jax(na, nb):
    rng = np.random.default_rng(na * nb)
    a, b = _poly(rng, na), _poly(rng, nb)
    got = P.pmul_ntt(a, b)
    assert got == J.pmul_ntt(a, b)
    assert got == P.pmul(a, b)


def test_domain_bn254_matches_jax():
    for k in list(range(13)) + [28]:
        d, jd = Domain.bn254(k), JDomain.bn254(k)
        assert (d.k, d.gen, d.n_inv, d.gen_inv) == (jd.k, jd.gen, jd.n_inv, jd.gen_inv)
        assert d.to_json() == jd.to_json()
        assert pow(d.gen, d.n, R) == 1 and (k == 0 or pow(d.gen, d.n // 2, R) != 1)
