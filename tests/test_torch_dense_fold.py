"""Port dense bucket folds (msm/cuda_ops.py::fold_level / fold_halving /
fold_grid and the drivers fold_buckets_chunked / fold_buckets_halving /
fold_buckets_grid_dense, on CPU tensors, i.e. svt_fold_segments' plain twin)
vs the JAX package's Pallas folds (_pallas_fold_level, _pallas_fold_halving,
_pallas_fold_grid and their drivers) run in interpret mode, as the JAX
package's own tests run them, and vs python-int sums; and the add-chain
probe's plain versions vs repeated adds and multiplies.

Tolerance: exact.  A partial level holds the same slot subsets on both
sides, summed in other orders, so levels and sums compare slot by slot in
affine form; the chains repeat the same op and compare limb for limb."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ec import G1 as JG1
from snark_verifier_tpu.ec import from_affine_int as j_from_affine
from snark_verifier_tpu.ec import to_affine_int as j_to_affine
from snark_verifier_tpu.ec.rns_g1 import FQ_RNS, G1R, to_rns
from snark_verifier_tpu.ff import FQ_FIELD as JFQ
from snark_verifier_tpu.msm import pallas_ops as po
from snark_verifier_tpu_torch.ec import from_jax_points, py_ec, to_affine_int, to_jax_points
from snark_verifier_tpu_torch.ff import FQ, FQ_FIELD, limbs_to_words, words_to_limbs
from snark_verifier_tpu_torch.msm import cuda_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = py_ec.rand_points(5, seed=51)


def _matrix(nb, w, seed):
    """A dense (nb, w) bucket matrix of BASE points and identities: the JAX
    layout (nb, w, 3, 16) u32, the port's words and the affine ints."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(BASE) + 1, size=(nb, w))  # len(BASE) = identity
    table = BASE + [None]
    aff = [[table[k] for k in row] for row in pick]
    limbs = np.asarray(j_from_affine([p for row in aff for p in row])).reshape(nb, w, 3, 16)
    return limbs, from_jax_points(limbs, device="cpu"), aff


def _rns(limbs):
    """(nb, w, 3, 16) limbs -> (nb, w, 105) u16 RNS rows, the Pallas layout."""
    nb, w = limbs.shape[:2]
    return jnp.asarray(np.asarray(to_rns(jnp.asarray(limbs))).reshape(nb, w, 105)
                       .astype(np.uint16))


def _rns_affine(out):
    """(nb, g, 105) Pallas output -> nested affine ints."""
    nb, g = out.shape[:2]
    flat = j_to_affine(FQ_RNS.to_limbs(jnp.asarray(out).reshape(nb * g, 3, 35)))
    return [flat[i * g : (i + 1) * g] for i in range(nb)]


def _port_affine(words):
    nb, g = words.shape[:2]
    flat = to_affine_int(to_jax_points(words.reshape(nb * g, 3, 8)))
    return [flat[i * g : (i + 1) * g] for i in range(nb)]


def _sums(aff, subsets):
    """Python-int sums of the given slot subsets of every bucket row."""
    out = []
    for row in aff:
        sums = []
        for subset in subsets:
            acc = None
            for k in subset:
                acc = py_ec.add(acc, row[k])
            sums.append(acc)
        out.append(sums)
    return out


IDENTITY_ROW = None


def _identity_row():
    global IDENTITY_ROW
    if IDENTITY_ROW is None:
        IDENTITY_ROW = jnp.asarray(np.asarray(G1R.infinity()).reshape(-1).astype(np.uint16))
    return IDENTITY_ROW


@pytest.mark.parametrize("K,w", [(2, 6), (4, 12)])
def test_fold_level_matches_pallas(K, w):
    limbs, words, aff = _matrix(2, w, seed=K + w)
    got = _port_affine(cuda_ops.fold_level(words, K))
    want = _rns_affine(po._pallas_fold_level(_rns(limbs), K, interpret=True))
    subsets = [[j * K + k for k in range(K)] for j in range(w // K)]
    assert got == want == _sums(aff, subsets)


@pytest.mark.parametrize("layers,w", [(1, 6), (2, 12)])
def test_fold_halving_matches_pallas(layers, w):
    limbs, words, aff = _matrix(2, w, seed=10 * layers + w)
    got = _port_affine(cuda_ops.fold_halving(words, layers))
    want = _rns_affine(po._pallas_fold_halving(_rns(limbs), layers, interpret=True))
    g = w >> layers
    subsets = [[j + k * g for k in range(1 << layers)] for j in range(g)]
    assert got == want == _sums(aff, subsets)


@pytest.mark.parametrize("wb,layers,w", [(4, 1, 8), (8, 2, 24)])
def test_fold_grid_matches_pallas(wb, layers, w):
    limbs, words, aff = _matrix(2, w, seed=wb + layers)
    got = _port_affine(cuda_ops.fold_grid(words, wb, layers))
    want = _rns_affine(po._pallas_fold_grid(_rns(limbs), wb, layers, interpret=True))
    g = wb >> layers
    subsets = [[(j // g) * wb + j % g + k * g for k in range(1 << layers)]
               for j in range((w // wb) * g)]
    assert got == want == _sums(aff, subsets)


@pytest.mark.parametrize("driver", ["chunked", "halving", "grid"])
@pytest.mark.parametrize("w", [21, 4])
def test_dense_drivers_match_pallas(driver, w):
    """Full folds; w = 21 needs identity padding."""
    limbs, words, aff = _matrix(2, w, seed=w)
    mat, ident = _rns(limbs), _identity_row()
    if driver == "chunked":
        got = cuda_ops.fold_buckets_chunked(words, K=4)
        want = po.fold_buckets_chunked(mat, ident, K=4, interpret=True)
    elif driver == "halving":
        got = cuda_ops.fold_buckets_halving(words, layers_per_call=2)
        want = po.fold_buckets_halving(mat, ident, layers_per_call=2, interpret=True)
    else:
        got = cuda_ops.fold_buckets_grid_dense(words, wb=8, layers=2)
        want = po.fold_buckets_grid(mat, ident, wb=8, layers=2, interpret=True)
    got_aff = to_affine_int(to_jax_points(got))
    want_aff = j_to_affine(FQ_RNS.to_limbs(jnp.asarray(want).reshape(-1, 3, 35)))
    assert got_aff == want_aff == [s[0] for s in _sums(aff, [range(w)])]


def test_fold_segments_rejects_bad_groupings():
    """A width that is no multiple of the grouping's reads as padded with
    identities (tests/test_torch_fold_segments_schedule.py); a grouping that
    does not tile or reads past its width is refused."""
    _, words, _ = _matrix(1, 12, seed=1)
    with pytest.raises(ValueError):
        cuda_ops.fold_grid(words, 6, 2)  # a chunk of 6 is no multiple of 2^2
    with pytest.raises(ValueError):
        cuda_ops.fold_segments(words, 1, 2, 1, 2, width=10)  # narrower than the matrix
    with pytest.raises(ValueError):
        cuda_ops.fold_segments(words, 1, 4, 1, 4, width=14)  # no multiple of count
    with pytest.raises(ValueError):
        cuda_ops.fold_segments(words, 1, 4, 1, 4, team=3)  # no team the kernel takes
    with pytest.raises(ValueError):
        cuda_ops.fold_segments(words, 1, 4, 4, 4)  # reads past the width
    with pytest.raises(ValueError):
        cuda_ops.fold_buckets_chunked(words, K=3)


def _rand_coords(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FQ.p + 1) for _ in range(3 * n)]
    return np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals],
                      dtype=np.uint32).reshape(n, 3, 16)


def test_add_chain_plain_matches_repeated_adds():
    a, b = _rand_coords(6, 1), _rand_coords(6, 2)
    got = to_jax_points(cuda_ops.g1_add_chain(from_jax_points(a, device="cpu"),
                                              from_jax_points(b, device="cpu"), 3))
    want = jnp.asarray(a)
    for _ in range(3):
        want = JG1.add(want, jnp.asarray(b))
    assert np.array_equal(got, np.asarray(want))  # same lazy limbs
    P, Q = py_ec.rand_points(2, seed=4)
    pw = from_jax_points(np.asarray(j_from_affine([P, None])), device="cpu")
    qw = from_jax_points(np.asarray(j_from_affine([Q, Q])), device="cpu")
    got = to_affine_int(to_jax_points(cuda_ops.g1_add_chain(pw, qw, 4)))
    assert got == [py_ec.add(P, py_ec.scalar_mul(Q, 4)), py_ec.scalar_mul(Q, 4)]


def test_mul_chain_plain_matches_repeated_muls():
    a = _rand_coords(4, 3)[:, 0]
    b = _rand_coords(4, 5)[:, 0]
    aw = limbs_to_words(torch.from_numpy(a.astype(np.int64)))
    bw = limbs_to_words(torch.from_numpy(b.astype(np.int64)))
    got = words_to_limbs(cuda_ops.fq_mul_chain(aw, bw, 5)).numpy()
    want = jnp.asarray(a)
    for _ in range(5):
        want = JFQ.mul(want, jnp.asarray(b))
    assert np.array_equal(got, np.asarray(want).astype(np.int64))
    R = 1 << 256
    for x, y, r in zip(a, b, got):
        xi, yi, ri = (FQ_FIELD.to_int(torch.from_numpy(v.astype(np.int64))) for v in (x, y, r))
        assert ri == xi * pow(yi, 5, FQ.p) % FQ.p
    assert cuda_ops.fq_mul_chain(aw, bw, 0).equal(aw)
