"""The port's CUDA kernels on the card, against their plain PyTorch twins and
the python-int oracle.  Marked `gpu`: each test skips (inside the test) where
no CUDA card is present.  This file imports neither jax nor the JAX package,
so it also runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance: exact; add and double canonically (and limb for limb), the fold
and the MSM in affine form (their summation orders differ from the twins')."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch.ec import (
    from_affine_int,
    limbs_to_words,
    py_ec,
    to_affine_int,
    words_to_limbs,
)
from snark_verifier_tpu_torch.ff import FQ_FIELD, FR
from snark_verifier_tpu_torch.msm import cuda_ops, msm, msm_checked, scalars_from_int

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_words(b, seed, device):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 16, size=(b, 3, 16), dtype=np.int64)
    raw[..., 15] &= 0x1FFF
    return limbs_to_words(torch.as_tensor(raw, device=device))


def _special_pairs(device):
    P = py_ec.rand_points(1, seed=3)[0]
    a = from_affine_int([None, P, P, P, None], device=device)
    b = from_affine_int([P, None, P, py_ec.neg(P), None], device=device)
    return limbs_to_words(a), limbs_to_words(b), [P, P, py_ec.double(P), None, None]


def test_add_kernel_matches_twin(cuda):
    a = _rand_words(4099, 1, cuda)
    b = _rand_words(4099, 2, cuda)
    sa, sb, want = _special_pairs(cuda)
    a, b = torch.cat([sa, a]), torch.cat([sb, b])
    cuda_ops.reset_launches()
    got = cuda_ops.add(a, b)
    assert cuda_ops.LAUNCHES["add"] == 1
    twin = cuda_ops.add_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, twin)
    assert torch.equal(FQ_FIELD.canon(words_to_limbs(got)), FQ_FIELD.canon(words_to_limbs(twin)))
    assert to_affine_int(words_to_limbs(got[:5])) == want


def test_double_kernel_matches_twin(cuda):
    a = _rand_words(3000, 3, cuda)
    sa, _, _ = _special_pairs(cuda)
    a = torch.cat([sa, a])
    got = cuda_ops.double(a)
    assert torch.equal(got, cuda_ops.double_plain(a))
    P = py_ec.rand_points(1, seed=3)[0]
    assert to_affine_int(words_to_limbs(got[1:2])) == [py_ec.double(P)]


def test_fold_kernel_matches_twin_and_oracle(cuda):
    base = py_ec.rand_points(6, seed=5)
    pts_ext = limbs_to_words(from_affine_int(base + [None], device=cuda))
    rng = np.random.default_rng(6)
    idx = torch.as_tensor(rng.integers(0, 7, size=(9, 700)), dtype=torch.int32, device=cuda)
    idx[0] = 6  # empty bucket
    got = cuda_ops.fold_buckets(pts_ext, idx)
    twin = cuda_ops.fold_buckets_plain(pts_ext, idx)
    ga = to_affine_int(words_to_limbs(got))
    assert ga == to_affine_int(words_to_limbs(twin))
    assert ga[0] is None
    counts = [np.bincount(r, minlength=7) for r in idx.cpu().numpy()]
    want = [py_ec.msm(base, [int(c) for c in row[:6]]) for row in counts]
    assert ga == want


def test_msm_on_card_matches_oracle(cuda):
    pts = py_ec.rand_points(300, seed=7)
    rng = np.random.default_rng(8)
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(300)]
    cuda_ops.reset_launches()
    out, ovf = msm(from_affine_int(pts), scalars_from_int(ks))
    assert out.device.type == "cuda" and not bool(ovf)
    assert all(cuda_ops.LAUNCHES[k] > 0 for k in ("add", "double", "fold_buckets"))
    assert to_affine_int(out) == py_ec.msm(pts, ks)
    cpu, _ = msm(from_affine_int(pts), scalars_from_int(ks), device="cpu")
    assert to_affine_int(cpu) == to_affine_int(out)


def test_msm_checked_retry_on_card(cuda):
    pts = py_ec.rand_points(64, seed=9)
    ks = [5] * 64
    _, ovf = msm(from_affine_int(pts), scalars_from_int(ks), capacity=8)
    assert bool(ovf)
    out = msm_checked(from_affine_int(pts), scalars_from_int(ks), capacity=8)
    assert to_affine_int(out) == py_ec.msm(pts, ks)


def _dense(nb, w, seed, device):
    base = py_ec.rand_points(4, seed=seed)
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 5, size=(nb, w))
    table = base + [None]
    aff = [[table[k] for k in row] for row in pick]
    flat = from_affine_int([p for row in aff for p in row], device=device)
    return limbs_to_words(flat).view(nb, w, 3, 8), aff


def _affine_rows(words):
    nb, g = words.shape[:2]
    flat = to_affine_int(words_to_limbs(words.reshape(nb * g, 3, 8)))
    return [flat[i * g : (i + 1) * g] for i in range(nb)]


@pytest.mark.parametrize("kind", ["level", "halving", "grid"])
def test_fold_segments_kernel_matches_twin(cuda, kind):
    mat, _ = _dense(3, 48, 11, cuda)
    fn = {"level": lambda m: cuda_ops.fold_level(m, 8),
          "halving": lambda m: cuda_ops.fold_halving(m, 4),
          "grid": lambda m: cuda_ops.fold_grid(m, 16, 2)}[kind]
    cuda_ops.reset_launches()
    got = fn(mat)
    assert cuda_ops.LAUNCHES["fold_segments"] == 1
    assert _affine_rows(got) == _affine_rows(fn(mat.cpu()))


@pytest.mark.parametrize("driver", ["chunked", "halving", "grid"])
def test_dense_drivers_on_card_match_oracle(cuda, driver):
    mat, aff = _dense(4, 300, 12, cuda)
    fn = {"chunked": cuda_ops.fold_buckets_chunked, "halving": cuda_ops.fold_buckets_halving,
          "grid": lambda m: cuda_ops.fold_buckets_grid_dense(m, wb=64, layers=3)}[driver]
    got = to_affine_int(words_to_limbs(fn(mat)))
    want = []
    for row in aff:
        acc = None
        for p in row:
            acc = py_ec.add(acc, p)
        want.append(acc)
    assert got == want


def test_chain_kernels_match_twins(cuda):
    a, b = _rand_words(300, 13, cuda), _rand_words(300, 14, cuda)
    assert torch.equal(cuda_ops.g1_add_chain(a, b, 5), cuda_ops.g1_add_chain_plain(a, b, 5))
    x, y = a[:, 0].contiguous(), b[:, 1].contiguous()
    assert torch.equal(cuda_ops.fq_mul_chain(x, y, 7), cuda_ops.fq_mul_chain_plain(x, y, 7))


@pytest.mark.parametrize("fname", ["fq", "fr"])
def test_field_kernels_match_twins(cuda, fname):
    from snark_verifier_tpu_torch.ff import FQW, FRW

    F = FQW if fname == "fq" else FRW
    p = F.spec.p
    rng = np.random.default_rng(15)
    vals = [0, 1, p - 1, p, 2 * p] + [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1)
                                       for _ in range(995)]
    raw = np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals])
    a = limbs_to_words(torch.as_tensor(raw, device=cuda))
    b = a.flip(0).contiguous()
    c = a[7]  # one element broadcast over the batch
    for op in ("mul", "add", "sub"):
        for x, y in ((a, b), (a, c), (c, b)):
            got = getattr(F, op)(x, y)
            assert torch.equal(got, getattr(F, op)(x.cpu(), y.cpu()).to(cuda)), op
    for op in ("neg", "canon", "inv"):
        src = a if op != "inv" else a[:64]
        assert torch.equal(getattr(F, op)(src), getattr(F, op)(src.cpu()).to(cuda)), op
    got = F.batch_inv(a[:40].view(5, 8, 8))
    want = F.batch_inv(a[:40].view(5, 8, 8).cpu())
    assert torch.equal(F.canon(got).cpu(), F.canon(want))


def test_poseidon_kernel_matches_twin_and_kat(cuda):
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.hash import permute, permute_plain

    rng = np.random.default_rng(16)
    st = FRW.from_int([int.from_bytes(rng.bytes(32), "little") for _ in range(3 * 257)])
    st = st.view(257, 3, 8).to(cuda)
    assert torch.equal(permute(st), permute_plain(st.cpu()).to(cuda))
    kat = permute(FRW.from_int([0, 1, 2]).view(1, 3, 8).to(cuda))
    assert list(FRW.to_int(kat[0])) == [
        7853200120776062878684798364095072458815029376092732009249414926327459813530,
        7142104613055408817911962100316808866448378443474503659992478482890339429929,
        6549537674122432311777789598043107870002137484850126429160507761192163713804,
    ]


def test_batch_succinct_verify_on_card_matches_oracle(cuda):
    from pathlib import Path

    from snark_verifier_tpu_torch._launch import LAUNCHES, reset_launches
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import load_params
    from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

    d = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
    srs = load_params(str(d / "srs.bin"))
    snarks = [Snark.load(str(d / f"snark_{i:02d}.json")) for i in range(3)]
    reset_launches()
    (lhs, rhs), = batch_succinct_verify(snarks, srs)
    for k in ("add", "double", "field_mul", "field_add", "field_sub", "field_inv",
              "field_canon", "poseidon_permute"):
        assert LAUNCHES[k] > 0, k
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    assert got == [succinct_verify_native(s, srs)[0] for s in snarks]


def test_wrappers_reject_on_card(cuda):
    a = _rand_words(8, 4, cuda)
    with pytest.raises(ValueError):
        cuda_ops.add(a, a.cpu())
    with pytest.raises(ValueError):  # a point buffer off 16-byte alignment
        flat = torch.empty(8 * 24 + 1, dtype=torch.int32, device=cuda)
        cuda_ops.double(flat[1:].view(8, 3, 8))
