"""The port's sharded MSM (`parallel.msm_sharded`, `batch_msm_sharded`)
over meshes of `["cpu"] * D`, every kernel's plain version: equal to the
python-int `py_ec.msm` (the port's and the JAX package's) and to the
port's one-device `msm` at D = 2, 3 and 4
(3 gives `_tree_fold` an odd width), `batch_msm_sharded` on a (2, 2) mesh
at the JAX package's dryrun shape (`__graft_entry__.py::dryrun_multichip`:
B = 4, n = 32, capacity 16, 4 base points from `rand_points(4, seed=3)`,
k_i = (7919 i + 13) mod 2^128) element by element, and the collective
inventory: two all-gathers, of D (3, 8)-word points and D flags.  The
shards' MSMs run with c = 4 windows here, through `msm` bound to that window
in the module under test (c = 8 costs ~10 s a CPU call; the card runs 8).

Tolerance: exact (affine ints)."""

import functools
import importlib

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import py_ec as j_py_ec

from snark_verifier_tpu_torch.ec import (
    from_affine_int, limbs_to_words, py_ec, to_affine_int, words_to_limbs,
)
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.msm import msm, scalars_from_int
from snark_verifier_tpu_torch.parallel import Mesh, batch_msm_sharded, msm_sharded
from snark_verifier_tpu_torch.parallel.comm_model import collective_inventory
from snark_verifier_tpu_torch.parallel.mesh import recording
from snark_verifier_tpu_torch.parallel.msm_sharded import _tree_fold

C = 4
# the module, not the function of the same name that the package exports
msm_sharded_module = importlib.import_module("snark_verifier_tpu_torch.parallel.msm_sharded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cheap_window(monkeypatch):
    monkeypatch.setattr(msm_sharded_module, "msm", functools.partial(msm, c=C))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = [py_ec.scalar_mul(py_ec.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    return pts, ks, from_affine_int(pts, device="cpu"), scalars_from_int(ks)


@pytest.mark.parametrize("D,n", [(2, 64), (3, 96)])
def test_msm_sharded_equals_oracle(D, n):
    pts, ks, P, S = _inputs(n, seed=D)
    out, ovf = msm_sharded(P, S, Mesh(["cpu"] * D, ("points",)))
    assert out.shape == (3, 16) and not bool(ovf)
    assert to_affine_int(out) == py_ec.msm(pts, ks) == j_py_ec.msm(pts, ks)


def test_msm_sharded_at_four_equals_msm_and_its_inventory():
    pts, ks, P, S = _inputs(128, seed=4)
    mesh = Mesh(["cpu"] * 4, ("points",))
    with recording() as ops:
        out, ovf = msm_sharded(P, S, mesh)
    want = py_ec.msm(pts, ks)
    assert want == j_py_ec.msm(pts, ks)
    assert not bool(ovf) and to_affine_int(out) == want
    assert to_affine_int(msm(P, S, c=C, device="cpu")[0]) == want
    assert ops == [{"op": "all-gather", "type": "s32[4,3,8]", "bytes": 4 * 96},
                   {"op": "all-gather", "type": "pred[4]", "bytes": 4}]
    # collective_inventory runs the function under the same recorder
    inv = collective_inventory(msm_sharded, P[:8], S[:8], mesh)
    assert inv == {"ops": ops, "count": 2, "total_bytes": 4 * 97}


def test_tree_fold_odd_widths_and_uneven_points():
    pts = [py_ec.scalar_mul(py_ec.G1_GEN, k) for k in (3, 5, 7, 11, 13)]
    words = from_affine_int(pts, device="cpu")
    for w in (1, 2, 3, 5):
        got = to_affine_int(words_to_limbs(_tree_fold(limbs_to_words(words[:w]))))
        want = None
        for p in pts[:w]:
            want = py_ec.add(want, p)
        assert got == want
    with pytest.raises(ValueError):
        msm_sharded(words, scalars_from_int([1] * 5), Mesh(["cpu"] * 2, ("points",)))


def test_batch_msm_sharded_at_the_dryrun_shape():
    shape, B, n = (2, 2), 4, 32
    base = py_ec.rand_points(4, seed=3)
    pts = [base[i % 4] for i in range(B * n)]
    ks = [(i * 7919 + 13) % (1 << 128) for i in range(B * n)]
    points = from_affine_int(pts, device="cpu").reshape(B, n, 3, 16)
    scalars = scalars_from_int(ks).reshape(B, n, 16)
    mesh = Mesh(np.array(["cpu"] * 4).reshape(shape), ("batch", "points"))
    with recording() as ops:
        out, ovf = batch_msm_sharded(points, scalars, mesh, capacity=16)
    assert out.shape == (B, 3, 16) and ovf.shape == (B,) and not bool(ovf.any())
    for b in range(B):
        lane = slice(b * n, (b + 1) * n)
        want = py_ec.msm(pts[lane], ks[lane])
        assert to_affine_int(out[b]) == want == j_py_ec.msm(pts[lane], ks[lane])
    assert [o["type"] for o in ops] == ["s32[2,2,3,8]", "pred[2,2]"]


@pytest.mark.slow
def test_inventory_against_the_jax_lowering():
    """The JAX package's inventory of its own msm_sharded at D = 4, from the
    lowered program (~1 minute to lower on a CPU): the same two all-gathers,
    its points in 16-bit limbs (twice the port's bytes), its flags i1[4]."""
    import jax

    from snark_verifier_tpu.msm import scalars_from_int as j_scalars
    from snark_verifier_tpu.ec import from_affine_int as j_points
    from snark_verifier_tpu.parallel import msm_sharded as j_msm_sharded
    from snark_verifier_tpu.parallel.comm_model import collective_inventory as j_inventory

    pts, ks, P, S = _inputs(64, seed=5)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("points",))
    j_inv = j_inventory(jax.jit(lambda p, s: j_msm_sharded(p, s, jmesh, capacity=16)),
                        j_points(pts), j_scalars(ks), optimized=False)
    inv = collective_inventory(msm_sharded, P, S, Mesh(["cpu"] * 4, ("points",)), capacity=16)
    assert [o["op"] for o in inv["ops"]] == [o["op"] for o in j_inv["ops"]] == ["all-gather"] * 2
    assert [o["bytes"] for o in j_inv["ops"]] == [2 * inv["ops"][0]["bytes"],
                                                  inv["ops"][1]["bytes"]]
