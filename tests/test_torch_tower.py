"""The port's plain tower (tower/tower.py, PyTorch on int64 limbs) against
the JAX package's eager FQ2 / FQ6 / FQ12 (tower/tower.py, no jit, as
tests/test_tower.py runs them), on the same numpy-seeded values: Fq2 and Fq6
here, with Fq12's conjugate.  Fq12's products and Frobenius maps are in
test_torch_tower_fq12.py, its inverse in test_torch_tower_inv.py: the JAX
package's eager tower takes 10-20 s per Fq6 or Fq12 operation (~50 s for
Fq12's inverse), whatever the lane count, and xdist runs the three files
side by side.  So one eager JAX product over the stacked lanes of every
product case of a degree (`jax_products`) is their common oracle: a·b for
`mul`, a·a for `square`.

Tolerance: exact, as canonical ints."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.tower import FQ2 as JFQ2, FQ6 as JFQ6, FQ12 as JFQ12
from snark_verifier_tpu.tower import fq2_from_int as j2, fq6_from_int as j6, fq12_from_int as j12
from snark_verifier_tpu.tower import fq2_to_int as j2i, fq6_to_int as j6i, fq12_to_int as j12i
from snark_verifier_tpu_torch.ff import limbs_to_words, words_to_limbs
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.tower import FQ2, FQ6, FQ12, tower_from_int, tower_to_int

LANES = 3
_SHAPE = {2: (2,), 6: (3, 2), 12: (2, 3, 2)}
_JENC = {2: j2, 6: j6, 12: j12}
_JDEC = {2: j2i, 6: j6i, 12: j12i}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_elems(seed, degree, n=LANES, zero_lane=False):
    """n elements of Fq^degree as nested int tuples, from numpy's generator."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % FQ.p for _ in range(n * degree)]
    if zero_lane:
        vals[:degree] = [0] * degree

    def nest(v, shape):
        if len(shape) == 1:
            return tuple(v)
        k = len(v) // shape[0]
        return tuple(nest(v[i * k:(i + 1) * k], shape[1:]) for i in range(shape[0]))

    return [nest(vals[i * degree:(i + 1) * degree], _SHAPE[degree]) for i in range(n)]


def jax_side(degree, elems):
    return jnp.stack([_JENC[degree](e) for e in elems])


def jax_ints(degree, arr):
    return [_JDEC[degree](arr[i]) for i in range(arr.shape[0])]


def port_side(degree, elems):
    return words_to_limbs(tower_from_int(elems, degree))


def port_ints(degree, limbs):
    return tower_to_int(limbs_to_words(limbs), degree)


_JMUL = {2: JFQ2.mul, 6: JFQ6.mul, 12: JFQ12.mul}


@functools.lru_cache(maxsize=None)
def jax_products(degree, cases):
    """cases: ((lefts, rights), ...) tuples of elements -> one list of
    canonical int products per case, from one eager JAX product call over
    all of their lanes."""
    lefts = [x for a, _ in cases for x in a]
    rights = [y for _, b in cases for y in b]
    flat = jax_ints(degree, _JMUL[degree](jax_side(degree, lefts), jax_side(degree, rights)))
    out, i = [], 0
    for a, _ in cases:
        out.append(flat[i:i + len(a)])
        i += len(a)
    return out


# The products: the port's function, and the index of its lanes in
# jax_products' cases ((a, b), (a, a)).
PRODUCTS = {"mul": (lambda F, a, b: F.mul(a, b), 0), "square": (lambda F, a, b: F.square(a), 1)}
CASES = {
    (2, "mul"): None,
    (2, "square"): None,
    (2, "conj"): (lambda a, b: JFQ2.conj(a), lambda a, b: FQ2.conj(a)),
    (2, "inv"): (lambda a, b: JFQ2.inv(a), lambda a, b: FQ2.inv(a)),
    (6, "mul"): None,
    (6, "square"): None,
    (6, "inv"): (lambda a, b: JFQ6.inv(a), lambda a, b: FQ6.inv(a)),
    (12, "conj"): (lambda a, b: JFQ12.conj(a), lambda a, b: FQ12.conj(a)),
}
_PORT = {2: FQ2, 6: FQ6, 12: FQ12}


@pytest.mark.parametrize("degree,op", list(CASES), ids=[f"fq{d}-{o}" for d, o in CASES])
def test_tower_op_matches_jax(degree, op):
    a = rand_elems(10 + degree, degree, zero_lane=op == "inv")
    b = rand_elems(20 + degree, degree)
    if CASES[(degree, op)] is None:
        pfn, k = PRODUCTS[op]
        pfn = functools.partial(pfn, _PORT[degree])
        want = jax_products(degree, ((tuple(a), tuple(b)), (tuple(a), tuple(a))))[k]
    else:
        jfn, pfn = CASES[(degree, op)]
        want = jax_ints(degree, jfn(jax_side(degree, a), jax_side(degree, b)))
    got = port_ints(degree, pfn(port_side(degree, a), port_side(degree, b)))
    assert got == want
    if op == "inv":
        assert got[0] == tower_to_int(tower_from_int(a[0], degree), degree)  # 0 -> 0
