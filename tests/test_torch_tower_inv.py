"""Fq12's inverse: the port's plain tower (tower/tower.py) against the
JAX package's eager FQ12.inv (no jit, ~55 s on its own; test_torch_tower.py
says why the tower's tests are three files), on the same numpy-seeded
values, a zero lane included (0 maps to 0).

Tolerance: exact, as canonical ints."""

from snark_verifier_tpu.tower import FQ12 as JFQ12
from snark_verifier_tpu_torch.tower import FQ12, tower_from_int, tower_to_int
from test_torch_tower import _one_torch_thread, jax_ints, jax_side, port_ints, port_side, rand_elems  # noqa: F401


def test_fq12_inv_matches_jax():
    a = rand_elems(41, 12, zero_lane=True)
    want = jax_ints(12, JFQ12.inv(jax_side(12, a)))
    got = port_ints(12, FQ12.inv(port_side(12, a)))
    assert got == want
    assert got[0] == tower_to_int(tower_from_int(a[0], 12), 12)  # 0 -> 0
