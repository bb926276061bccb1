"""Port G1 (ec/, msm/cuda_ops.py add and double on CPU tensors, i.e. their
plain twins) vs the JAX package's G1 (ec/curve.py, ec/g1.py) and the
python-int oracle, on the same numpy-seeded inputs.

Tolerance: exact.  Points are compared canonically (projective, since RC15
is the same polynomial on both sides) or in affine form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ec import G1 as JG1, from_affine_int as j_from_affine
from snark_verifier_tpu.ec import to_affine_int as j_to_affine
from snark_verifier_tpu.ff import FQ_FIELD as JFQ
from snark_verifier_tpu_torch.ec import (
    G1,
    from_affine_int,
    from_jax_points,
    generator,
    py_ec,
    to_affine_int,
    to_jax_points,
    words_to_limbs,
)
from snark_verifier_tpu_torch.ff import FQ, FQ_FIELD
from snark_verifier_tpu_torch.msm import cuda_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_triples(n, seed):
    """(n, 3, 16) uint32 limb arrays of arbitrary projective triples, values
    in [0, 2p] (lazy representations included)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FQ.p + 1) for _ in range(3 * n)]
    limbs = [[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals]
    return np.asarray(limbs, dtype=np.uint32).reshape(n, 3, 16)


def _cases():
    """JAX-layout point pairs: random triples, real points, and the lanes
    the complete formulas must get right: identity, P == Q, P == -Q."""
    pts = py_ec.rand_points(3, seed=11)
    P, Q, S = pts
    aff_a = [None, P, P, P, None, Q, S]
    aff_b = [P, None, P, py_ec.neg(P), None, S, Q]
    a = np.concatenate([_rand_triples(9, 1), np.asarray(j_from_affine(aff_a))])
    b = np.concatenate([_rand_triples(9, 2), np.asarray(j_from_affine(aff_b))])
    return a, b, aff_a, aff_b


def _canon(pts_u32):
    return FQ_FIELD.canon(torch.from_numpy(np.asarray(pts_u32).astype(np.int64))).numpy()


def test_add_matches_jax():
    a, b, aff_a, aff_b = _cases()
    aw, bw = from_jax_points(a, device="cpu"), from_jax_points(b, device="cpu")
    got = to_jax_points(cuda_ops.add(aw, bw))
    want = np.asarray(JG1.add(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(_canon(got), _canon(want))
    assert np.array_equal(got, want)  # same lazy representation, limb for limb
    k = len(aff_a)
    assert to_affine_int(got[-k:]) == [py_ec.add(x, y) for x, y in zip(aff_a, aff_b)]


def test_double_matches_jax():
    a, _, aff_a, _ = _cases()
    got = to_jax_points(cuda_ops.double(from_jax_points(a, device="cpu")))
    want = np.asarray(JG1.double(jnp.asarray(a)))
    assert np.array_equal(_canon(got), _canon(want))
    assert np.array_equal(got, want)
    k = len(aff_a)
    assert to_affine_int(got[-k:]) == [py_ec.double(x) for x in aff_a]


def test_jax_points_roundtrip():
    a = _rand_triples(16, 3)
    w = from_jax_points(a, device="cpu")
    assert w.dtype == torch.int32 and tuple(w.shape) == (16, 3, 8)
    back = to_jax_points(w)
    assert back.dtype == np.uint32 and np.array_equal(back, a)
    from_jax = from_jax_points(np.asarray(jnp.asarray(a)), device="cpu")
    assert np.array_equal(to_jax_points(from_jax), a)
    assert torch.equal(from_jax_points(torch.from_numpy(a.astype(np.int64)), device="cpu"), w)


def test_affine_encoding_matches_jax():
    pts = py_ec.rand_points(4, seed=3) + [None]
    ours = from_affine_int(pts)
    assert np.array_equal(ours.numpy(), np.asarray(j_from_affine(pts)).astype(np.int64))
    assert to_affine_int(ours) == pts == j_to_affine(j_from_affine(pts))
    assert to_affine_int(generator()) == py_ec.G1_GEN


def test_tree_sum_and_to_affine_match_oracle():
    pts = py_ec.rand_points(5, seed=8)
    total = G1.tree_sum(from_affine_int(pts))
    want = None
    for pt in pts:
        want = py_ec.add(want, pt)
    assert to_affine_int(total) == want
    x, y, inf = G1.to_affine(total)
    assert not bool(inf)
    assert (FQ_FIELD.to_int(x), FQ_FIELD.to_int(y)) == want
    assert bool(G1.to_affine(G1.infinity())[2])


def test_neg_matches_jax():
    a = _rand_triples(6, 4)
    got = G1.neg(torch.from_numpy(a.astype(np.int64))).numpy()
    assert np.array_equal(got, np.asarray(JG1.neg(jnp.asarray(a))).astype(np.int64))


def test_wrappers_reject_bad_inputs():
    w = from_jax_points(_rand_triples(4, 5), device="cpu")
    with pytest.raises(TypeError):
        cuda_ops.add(w.to(torch.int64), w)
    with pytest.raises(ValueError):
        cuda_ops.add(w, w[:3])
    with pytest.raises(ValueError):
        cuda_ops.double(w.transpose(0, 1))
    with pytest.raises(ValueError):
        cuda_ops.fold_buckets(w, torch.zeros(2, 3, dtype=torch.int32)[:, ::2])


def test_plain_twins_count_no_launches():
    cuda_ops.reset_launches()
    w = from_jax_points(_rand_triples(2, 6), device="cpu")
    cuda_ops.add(w, w)
    cuda_ops.double(w)
    cuda_ops.fold_level(w.view(1, 2, 3, 8), 2)
    assert {"add", "double", "fold_buckets", "fold_segments"} <= set(cuda_ops.LAUNCHES)
    assert all(v == 0 for v in cuda_ops.LAUNCHES.values())
    assert words_to_limbs(w).dtype == torch.int64


def test_msm_windowed_and_tree_sum_match_jax():
    """The verify-path MSM (c = 4 windows, shared doublings) over bases with
    the identity among them, and the halving tree sum with an odd width."""
    pts = py_ec.rand_points(4, seed=12) + [None]
    rng = np.random.default_rng(13)
    digits = rng.integers(0, 16, size=(5, 6)).astype(np.uint32)
    jpts = j_from_affine(pts)
    wpts = from_jax_points(np.asarray(jpts), device="cpu")
    got = cuda_ops.msm_windowed(wpts, torch.from_numpy(digits.astype(np.int64)), c=4)
    want = JG1.msm_windowed(jpts, jnp.asarray(digits), c=4)
    ks = [sum(int(d) << (4 * w) for w, d in enumerate(row)) for row in digits]
    assert to_affine_int(to_jax_points(got)) == j_to_affine(want) == py_ec.msm(pts, ks)
    got = cuda_ops.tree_sum(wpts, dim=0)
    want = JG1.tree_sum(jpts, axis=0)
    assert np.array_equal(to_jax_points(got), np.asarray(want))  # same adds, same limbs
    x, y, inf = cuda_ops.to_affine(torch.stack([got, cuda_ops.identity((), "cpu")]))
    assert inf.tolist() == [False, True]
    assert (FQ_FIELD.to_int(words_to_limbs(x[0])), FQ_FIELD.to_int(words_to_limbs(y[0]))) \
        == to_affine_int(to_jax_points(got))
