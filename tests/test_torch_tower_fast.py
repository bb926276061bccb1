"""The least Fq12 formulas of the pairing kernels in the port's plain tower
(tower/tower.py: square_complex, mul_by_034_sparse, cyclotomic_square)
against the JAX package's eager FQ12.mul(a, a) and FQ12.mul_by_034 (no
jit) and the python-int oracle (pairing/py_pairing.py), on the same
numpy-seeded values.  The cyclotomic square is the square only inside the
cyclotomic subgroup, so it takes real subgroup elements
f^((p^6 - 1)(p^2 + 1)) and 0; the final-exponentiation tape must square
only such values, which the last test checks row by row.  One eager JAX
product over every squared lane and one JAX line product are the module's
JAX cost (~10-20 s each).

Tolerance: exact, as canonical ints."""

import functools

import pytest
import torch

from snark_verifier_tpu.pairing import py_pairing as jpp
from snark_verifier_tpu.tower import FQ12 as JFQ12
from snark_verifier_tpu_torch.ff.spec import FQ
from snark_verifier_tpu_torch.pairing import fq12_vm
from snark_verifier_tpu_torch.tower import FQ12
from test_torch_tower import (  # noqa: F401
    _one_torch_thread, jax_ints, jax_side, port_ints, port_side, rand_elems,
)

ZERO12 = ((((0, 0),) * 3),) * 2


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): the easy part of the final exponentiation,
    an element of the cyclotomic subgroup."""
    m = jpp.f12_mul(jpp.f12_conj(f), jpp.f12_inv(f))
    return jpp.f12_mul(jpp.f12_frob(m, 2), m)


@functools.lru_cache(maxsize=None)
def _elements():
    a = rand_elems(51, 12)
    cyc = [_cyclotomic(x) for x in rand_elems(52, 12)] + [ZERO12]
    return tuple(a), tuple(cyc)


@functools.lru_cache(maxsize=None)
def _jax_squares():
    """JAX's FQ12.mul(x, x) over the random lanes, then the subgroup lanes."""
    a, cyc = _elements()
    both = list(a) + list(cyc)
    sq = jax_ints(12, JFQ12.mul(jax_side(12, both), jax_side(12, both)))
    return sq[:len(a)], sq[len(a):]


def test_square_complex_matches_jax_and_oracle():
    a = list(_elements()[0])
    got = port_ints(12, FQ12.square_complex(port_side(12, a)))
    assert got == _jax_squares()[0]
    assert got == [jpp.f12_sq(x) for x in a]


def test_mul_by_034_sparse_matches_jax_and_oracle():
    f = rand_elems(53, 12)
    lines = [x[0] for x in rand_elems(54, 12)]  # (c0, c3, c4) Fq2 triples
    fs, ls = port_side(12, f), port_side(6, lines)
    got = port_ints(12, FQ12.mul_by_034_sparse(fs, ls[..., 0, :, :], ls[..., 1, :, :],
                                               ls[..., 2, :, :]))
    jl = jax_side(6, lines)
    want = jax_ints(12, JFQ12.mul_by_034(jax_side(12, f), jl[:, 0], jl[:, 1], jl[:, 2]))
    assert got == want
    assert got == [jpp.f12_mul_by_034(x, *c) for x, c in zip(f, lines)]


def test_cyclotomic_square_on_the_subgroup_matches_jax_and_oracle():
    a, cyc = map(list, _elements())
    got = port_ints(12, FQ12.cyclotomic_square(port_side(12, cyc)))
    assert got == _jax_squares()[1]
    assert got == [jpp.f12_sq(x) for x in cyc]
    assert got[-1] == ZERO12  # 0 maps to 0
    # outside the subgroup it is not the square: the inputs above matter
    off = port_ints(12, FQ12.cyclotomic_square(port_side(12, a)))
    assert all(x != y for x, y in zip(off, _jax_squares()[0]))


def test_tape_squares_only_cyclotomic_values():
    """Every row of build_final_exp_tape() that the kernel runs as a
    cyclotomic square (src1 == src2, the identity transform) squares a value
    of the subgroup: tracked as exponents of m = f^(p^6 - 1), whose powers
    form a group of order p^6 + 1 = (p^2 + 1)(p^4 - p^2 + 1), a value m^E
    lies in the cyclotomic subgroup when p^2 + 1 divides E (conj12 of m^E
    is m^-E, frobenius^k is m^(E p^k)).  No square row comes before the row
    that completes m^(p^2 + 1)."""
    p, order = FQ.p, FQ.p ** 6 + 1
    tape = fq12_vm.build_final_exp_tape()
    exps = [0] * fq12_vm.NREG
    exps[1] = 1  # R[1] = m
    completes, squares = None, []
    for row, (s1, s2, dst, tid) in enumerate(tape.tolist()):
        e = exps[s1]
        if tid == fq12_vm.T_CONJ12:
            e = -e
        elif tid != fq12_vm.T_IDENTITY:
            e *= p ** (tid - fq12_vm.T_FROB1 + 1)
        if s2 != fq12_vm.R_ONE and s1 == s2 and tid == fq12_vm.T_IDENTITY:
            squares.append((row, exps[s1]))
        exps[dst] = (e + exps[s2]) % order
        if completes is None and exps[dst] and exps[dst] % (p ** 2 + 1) == 0:
            completes = row
    assert completes == 1  # t.mul(M, A, M): frob2(m) m = m^(p^2 + 1)
    assert len(squares) == 190
    assert all(row > completes and e % (p ** 2 + 1) == 0 for row, e in squares)
    # the final value is m^((p^4 - p^2 + 1)/r · (p^2 + 1)) up to the hard
    # part's multiple: a power of m^(p^2 + 1)
    assert exps[1] % (p ** 2 + 1) == 0


@pytest.mark.parametrize("op", ["square_complex", "mul_by_034_sparse", "cyclotomic_square"])
def test_fast_formulas_count_their_products(op, monkeypatch):
    """The plain formulas run the multiplies the kernels' counts assume: 12
    and 13 Fq2 products and 9 Fq2 squares (36, 39 and 18 Fq multiplies), in
    one stacked base-field multiply call each, on one lane."""
    from snark_verifier_tpu_torch.tower import tower as tw

    calls = []
    real = tw.F.mul

    def counting(a, b):
        calls.append(torch.broadcast_shapes(a.shape, b.shape).numel() // 16)  # Fq multiplies
        return real(a, b)

    monkeypatch.setattr(tw.F, "mul", counting)
    a = port_side(12, rand_elems(55, 12, n=1))
    lines = port_side(6, [rand_elems(56, 12, n=1)[0][0]])
    if op == "mul_by_034_sparse":
        FQ12.mul_by_034_sparse(a, lines[..., 0, :, :], lines[..., 1, :, :], lines[..., 2, :, :])
    else:
        getattr(FQ12, op)(a)
    assert len(calls) == 1 and calls[0] == {"square_complex": 36, "mul_by_034_sparse": 39,
                                            "cyclotomic_square": 18}[op]
