"""Fq12's products and Frobenius maps: the port's plain tower
(tower/tower.py, pairing/pairing.py::f12_frobenius) against the JAX
package's eager FQ12 and f12_frobenius (no jit), on the same numpy-seeded
values (test_torch_tower.py says why the tower's tests are three files).
The three products share one eager JAX product over their stacked lanes:
a·b for `mul`, a·a for `square`, a·ℓ for `mul_by_034`, where ℓ is the
sparse element with b's coordinates 0, 3 and 4 and zeros elsewhere.

Tolerance: exact, as canonical ints."""

import pytest

from snark_verifier_tpu.pairing.pairing import f12_frobenius as j_frob
from snark_verifier_tpu_torch.pairing.pairing import f12_frobenius
from snark_verifier_tpu_torch.tower import FQ12
from test_torch_tower import (  # noqa: F401
    _one_torch_thread, jax_ints, jax_products, jax_side, port_ints, port_side, rand_elems,
)


def _034(F, a, b):
    return F.mul_by_034(a, b[..., 0, 0, :, :], b[..., 1, 0, :, :], b[..., 1, 1, :, :])


def _sparse034(b):
    """The Fq12 element of b's coordinates 0, 3 and 4 (c0, c3, c4)."""
    z = (0, 0)
    return ((b[0][0], z, z), (b[1][0], b[1][1], z))


# The products: the port's function, and the index of its lanes in
# jax_products' cases ((a, b), (a, a), (a, ℓ)).
PRODUCTS = {
    "mul": (lambda a, b: FQ12.mul(a, b), 0),
    "square": (lambda a, b: FQ12.square(a), 1),
    "mul_by_034": (lambda a, b: _034(FQ12, a, b), 2),
}
CASES = {
    "frob1": (lambda a, b: j_frob(a, 1), lambda a, b: f12_frobenius(a, 1)),
    "frob2": (lambda a, b: j_frob(a, 2), lambda a, b: f12_frobenius(a, 2)),
    "frob3": (lambda a, b: j_frob(a, 3), lambda a, b: f12_frobenius(a, 3)),
}


@pytest.mark.parametrize("op", list(PRODUCTS) + list(CASES))
def test_fq12_op_matches_jax(op):
    a = rand_elems(31, 12)
    b = rand_elems(32, 12)
    if op in PRODUCTS:
        pfn, k = PRODUCTS[op]
        sparse = tuple(_sparse034(x) for x in b)
        want = jax_products(12, ((tuple(a), tuple(b)), (tuple(a), tuple(a)),
                                 (tuple(a), sparse)))[k]
    else:
        jfn, pfn = CASES[op]
        want = jax_ints(12, jfn(jax_side(12, a), jax_side(12, b)))
    assert port_ints(12, pfn(port_side(12, a), port_side(12, b))) == want
