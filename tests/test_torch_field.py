"""Port field core (snark_verifier_tpu_torch/ff/limb_field.py) vs the JAX
package's LimbField (ff/jnp_field.py), on the same numpy-seeded inputs.

Tolerance: exact.  Outputs are compared canonically and, since the port keeps
the JAX package's lazy [0, 2p] contract op for op, also limb for limb."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ff import FQ_FIELD as JFQ, FR_FIELD as JFR
from snark_verifier_tpu.ff.jnp_field import u16_limbs_to_digits4
from snark_verifier_tpu_torch.ff import FQ, FR, FQ_FIELD as TFQ, FR_FIELD as TFR
from snark_verifier_tpu_torch.ff import FQW, FRW, digits4, from_jax_elems, to_jax_elems
from snark_verifier_tpu_torch.ff.spec import int_to_limbs, limbs_to_int


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"fq": (FQ, JFQ, TFQ), "fr": (FR, JFR, TFR)}


def _lazy_reprs(p, seed, n=24):
    """(n, 16) uint32 limb arrays of representations in [0, 2p]: edge values
    0, 1, p-1, p, p+1, 2p-1, 2p and random values in [0, p) and [p, 2p]."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p]
    while len(vals) < n:
        r = int.from_bytes(rng.bytes(32), "little") % p
        vals.append(r if len(vals) % 2 else r + p)
    return np.stack([int_to_limbs(v) for v in vals])


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int64))


def _assert_same(field_t, got_t, want_j):
    want = np.asarray(want_j).astype(np.int64)
    got = got_t.numpy()
    assert np.array_equal(field_t.canon(got_t).numpy(),
                          field_t.canon(torch.from_numpy(want)).numpy())
    assert np.array_equal(got, want)  # the lazy representation matches too


@pytest.mark.parametrize("fname", ["fq", "fr"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(fname, op):
    spec, fj, ft = FIELDS[fname]
    a = _lazy_reprs(spec.p, 1)
    b = _lazy_reprs(spec.p, 2)[::-1].copy()  # pair edges with randoms
    aj, at = _both(a)
    bj, bt = _both(b)
    _assert_same(ft, getattr(ft, op)(at, bt), getattr(fj, op)(aj, bj))


@pytest.mark.parametrize("fname", ["fq", "fr"])
@pytest.mark.parametrize("op", ["double", "neg", "canon", "mul_small3", "mul_small9"])
def test_unary_ops_match_jax(fname, op):
    spec, fj, ft = FIELDS[fname]
    aj, at = _both(_lazy_reprs(spec.p, 3))
    if op.startswith("mul_small"):
        k = int(op[len("mul_small"):])
        got, want = ft.mul_small(at, k), fj.mul_small(aj, k)
    else:
        got, want = getattr(ft, op)(at), getattr(fj, op)(aj)
    _assert_same(ft, got, want)


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_inv_matches_jax_and_ints(fname):
    spec, fj, ft = FIELDS[fname]
    a = _lazy_reprs(spec.p, 4, n=8)
    aj, at = _both(a)
    got = ft.inv(at)
    _assert_same(ft, got, fj.inv(aj))
    R = 1 << 256
    for limbs, inv_limbs in zip(a, got.numpy()):
        x = limbs_to_int(limbs) * pow(R, -1, spec.p) % spec.p
        y = limbs_to_int(inv_limbs) * pow(R, -1, spec.p) % spec.p
        assert y == (pow(x, -1, spec.p) if x else 0)


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_int_conversions_match_jax(fname):
    spec, fj, ft = FIELDS[fname]
    rng = np.random.default_rng(5)
    xs = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(32), "little") for _ in range(9)]
    got = ft.from_int(xs)
    assert np.array_equal(got.numpy(), np.asarray(fj.from_int(xs)).astype(np.int64))
    assert list(ft.to_int(got)) == [x % spec.p for x in xs]
    assert ft.to_int(ft.from_int(xs[4])) == xs[4] % spec.p


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_is_zero(fname):
    spec, fj, ft = FIELDS[fname]
    a = torch.from_numpy(np.stack([int_to_limbs(v) for v in (0, spec.p, 2 * spec.p, 1)])
                         .astype(np.int64))
    assert ft.is_zero(a).tolist() == [True, True, True, False]
    assert fj.is_zero(jnp.asarray(a.numpy().astype(np.uint32))).tolist() == [True] * 3 + [False]


# ------------------------------------------- the verifier's word-layout field

WORD_FIELDS = {"fq": (FQ, JFQ, FQW), "fr": (FR, JFR, FRW)}


def _words(arr):
    return from_jax_elems(arr, device="cpu")


def _canon_ints(F, words):
    return [int(v) for v in np.asarray(F.to_int(words)).reshape(-1)]


@pytest.mark.parametrize("fname", ["fq", "fr"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_word_field_ops_match_jax(fname, op):
    spec, fj, fw = WORD_FIELDS[fname]
    a, b = _lazy_reprs(spec.p, 6), _lazy_reprs(spec.p, 7)[::-1].copy()
    got = to_jax_elems(getattr(fw, op)(_words(a), _words(b)))
    assert np.array_equal(got, np.asarray(getattr(fj, op)(jnp.asarray(a), jnp.asarray(b))))
    one = fw.scalar(3, "cpu")  # a broadcast (8,) constant
    got = to_jax_elems(getattr(fw, op)(_words(a), one))
    assert np.array_equal(got, np.asarray(getattr(fj, op)(jnp.asarray(a), fj.from_int(3))))


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_word_field_pow_inv_and_montgomery_match_jax(fname):
    spec, fj, fw = WORD_FIELDS[fname]
    a = _lazy_reprs(spec.p, 8, n=10)
    aj, aw = jnp.asarray(a), _words(a)
    for e in (0, 1, 5, 1024):
        assert _canon_ints(fw, fw.pow_static(aw, e)) == \
            [int(v) for v in np.asarray(fj.to_int(fj.pow_static(aj, e))).reshape(-1)]
    assert _canon_ints(fw, fw.inv(aw)) == [int(v) for v in np.asarray(fj.to_int(fj.inv(aj)))]
    plain = np.stack([int_to_limbs(v % spec.p) for v in (0, 1, 5, spec.p - 1)])
    mont = fw.to_mont(_words(plain))
    assert np.array_equal(to_jax_elems(mont), np.asarray(fj.to_mont(jnp.asarray(plain))))
    assert np.array_equal(to_jax_elems(fw.from_mont(mont)), plain)
    assert np.array_equal(to_jax_elems(fw.from_mont(aw)), np.asarray(fj.from_mont(aj)))


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_word_field_batch_inv_matches_jax(fname):
    """A sequential prefix where JAX scans in parallel: the same values,
    compared canonically; zeros (0, p and 2p) map to zero."""
    spec, fj, fw = WORD_FIELDS[fname]
    a = _lazy_reprs(spec.p, 9, n=12).reshape(6, 2, 16)
    got = fw.batch_inv(_words(a))
    want = fj.batch_inv(jnp.asarray(a))
    assert _canon_ints(fw, got) == [int(v) for v in np.asarray(fj.to_int(want)).reshape(-1)]
    vals = _canon_ints(fw, _words(a))
    assert _canon_ints(fw, got) == [pow(v, -1, spec.p) if v else 0 for v in vals]


def test_digits4_match_jax():
    rng = np.random.default_rng(10)
    vals = [0, FR.p - 1] + [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(6)]
    limbs = np.stack([int_to_limbs(v) for v in vals])
    got = digits4(_words(limbs)).numpy()  # (8, 64) int64
    assert np.array_equal(got, np.asarray(u16_limbs_to_digits4(jnp.asarray(limbs)))
                          .astype(np.int64))
    assert [sum(int(d) << (4 * i) for i, d in enumerate(row)) for row in got] == vals
