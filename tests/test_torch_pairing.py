"""The port's pairing against the JAX package: host line preparation and
the final-exponentiation tape word for word, the plain Miller loop and final
exponentiation against the JAX package's python-int oracle
(pairing/py_pairing.py), and the decide on the plain path (device="cpu")
over the port's toy SRS.  The JAX package's device pairing is not jitted
here: its compiles take minutes (tests/test_pairing.py marks them slow).

Tolerance: exact (words for the host arrays, canonical ints elsewhere)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu.pairing import py_pairing as jpp
from snark_verifier_tpu.pairing.fq12_vm import build_final_exp_tape as j_tape
from snark_verifier_tpu.pairing.pairing import prepare_g2_coeffs as j_prepare
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu_torch.ec import from_affine_int_np, py_ec
from snark_verifier_tpu_torch.ff import FQW, np_limbs_to_words
from snark_verifier_tpu_torch.ff.spec import FQ, FR
from snark_verifier_tpu_torch.loader.base import TorchLoader
from snark_verifier_tpu_torch.pairing import fq12_vm
from snark_verifier_tpu_torch.pairing import py_pairing as pp
from snark_verifier_tpu_torch.pairing.pairing import (
    NSTEPS,
    final_exponentiation,
    miller_loop,
    prepare_g2_coeffs,
    prepare_pairs,
)
from snark_verifier_tpu_torch.pcs.kzg.decider import decide
from snark_verifier_tpu_torch.sdk.srs import load_params, toy_srs
from snark_verifier_tpu_torch.tower import fq12_from_int, fq12_to_int

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_f12(seed):
    rng = np.random.default_rng(seed)
    v = [int.from_bytes(rng.bytes(32), "little") % FQ.p for _ in range(12)]
    return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))


def test_oracle_copy_matches_jax():
    assert pp.NAF_DIGITS == jpp.NAF_DIGITS and len(pp.NAF_DIGITS) - 1 == NSTEPS
    assert (pp.FROB_FQ12_C1, pp.FROB_FQ6_C1, pp.FROB_FQ6_C2) == (
        jpp.FROB_FQ12_C1, jpp.FROB_FQ6_C1, jpp.FROB_FQ6_C2)
    q = pp.g2_scalar_mul(pp.G2_GEN, 31337)
    assert q == jpp.g2_scalar_mul(jpp.G2_GEN, 31337)
    assert pp.prepare_g2(q) == jpp.prepare_g2(q)


def test_decider_coeffs_match_jax_word_for_word():
    srs = load_params(str(FIXTURES / "srs.bin"))
    j_srs = j_load_params(str(FIXTURES / "srs.bin"))
    ours = prepare_g2_coeffs([srs.g2, pp.g2_neg(srs.s_g2)])
    theirs = j_prepare([j_srs.g2, jpp.g2_neg(j_srs.s_g2)])
    dbl, addc, has_add, finals = ours
    assert dbl.shape == (NSTEPS, 2, 3, 2, 8) and dbl.dtype == np.int32
    assert np.array_equal(has_add, theirs[2]) and int(has_add.sum()) == 21
    for a, b in ((dbl, theirs[0]), (addc, theirs[1]), (finals, theirs[3])):
        assert np.array_equal(a, np_limbs_to_words(b))
    cached = srs.decider_coeffs_host
    assert all(np.array_equal(a, b) for a, b in zip(cached, ours))
    for a, b in zip(srs.decider_coeffs("cpu"), ours):
        assert np.array_equal(np.asarray(a), b)


def test_tape_matches_jax_word_for_word():
    tape = fq12_vm.build_final_exp_tape()
    assert tape.shape == (406, 4)
    src1, src2, dst, conj, coeffs = fq12_vm.expand_tape(tape)
    j_src1, j_src2, j_dst, j_conj, j_coeffs = j_tape()
    for a, b in ((src1, j_src1), (src2, j_src2), (dst, j_dst), (conj, j_conj), (coeffs, j_coeffs)):
        assert np.array_equal(a, b)
    assert int((tape[:, 1] == fq12_vm.R_ONE).sum()) == 121
    # the kernels' constant table holds the three Frobenius sets the tape names
    tab = fq12_vm.transform_table()
    for power, tid in ((1, fq12_vm.T_FROB1), (2, fq12_vm.T_FROB2)):
        rows = np.nonzero(tape[:, 3] == tid)[0]
        assert rows.size and np.array_equal(np_limbs_to_words(coeffs[rows[0]]), tab[power - 1])


def test_miller_loop_plain_matches_oracle():
    g1, g2 = py_ec.G1_GEN, pp.G2_GEN
    pairs = [(py_ec.scalar_mul(g1, 777), g2), (g1, pp.g2_scalar_mul(g2, 31337))]
    want = jpp.miller_loop([(p, jpp.prepare_g2(q)) for p, q in pairs])
    xs, ys, dbl, addc, has_add, finals = (
        torch.from_numpy(a) if a.dtype != np.bool_ else a for a in prepare_pairs(pairs))
    ones = FQW.from_int([1, 1])[None]  # affine: Z = 1
    f = miller_loop(xs[None], ys[None], ones, dbl, addc, has_add, finals)
    assert fq12_to_int(f[0]) == want


def test_final_exponentiation_plain_matches_oracle():
    f = _rand_f12(7)
    got = final_exponentiation(fq12_from_int([f]))
    assert fq12_to_int(got[0]) == jpp.final_exponentiation(f)


def test_toy_srs_matches_jax():
    ours, theirs = toy_srs(8), j_toy_srs(8)
    assert ours.g1_powers == theirs.g1_powers
    assert (ours.g2, ours.s_g2) == (theirs.g2, theirs.s_g2)
    assert ours.tau == theirs._tau


def test_decide_plain_accepts_valid_and_rejects_tampered():
    """One CPU batch of four lanes on toy_srs(8): a valid accumulator
    (lhs = τ·rhs), the same projectively scaled (Z ≠ 1), lhs + G, and both
    sides at infinity."""
    srs = toy_srs(8)
    k = 123456789
    rhs = py_ec.scalar_mul(py_ec.G1_GEN, k)
    lhs = py_ec.scalar_mul(py_ec.G1_GEN, k * srs.tau % FR.p)
    bad = py_ec.add(lhs, py_ec.G1_GEN)
    L = torch.from_numpy(from_affine_int_np([lhs, lhs, bad, None]))
    R = torch.from_numpy(from_affine_int_np([rhs, rhs, rhs, None]))
    # lane 1: (λX : λY : λ) for a λ != 1, the same points
    lam = FQW.from_int([5, 11])
    L[1] = FQW.mul(L[1], lam[0])
    R[1] = FQW.mul(R[1], lam[1])
    ok = decide(srs, L, R)
    assert ok.tolist() == [True, True, False, True]
    assert jpp.pairing_check([(lhs, srs.g2), (rhs, jpp.g2_neg(srs.s_g2))])


def test_loader_decide_all_needs_every_accumulator():
    """TorchLoader.decide_all: a lane accepts only if each of its
    accumulators does (two accumulators of two lanes; lane 1's second
    accumulator is lhs + G)."""
    srs = toy_srs(8)
    rhs = py_ec.scalar_mul(py_ec.G1_GEN, 98765)
    lhs = py_ec.scalar_mul(py_ec.G1_GEN, 98765 * srs.tau % FR.p)
    bad = py_ec.add(lhs, py_ec.G1_GEN)
    R = torch.from_numpy(from_affine_int_np([rhs, rhs]))
    good = torch.from_numpy(from_affine_int_np([lhs, lhs]))
    mixed = torch.from_numpy(from_affine_int_np([lhs, bad]))
    ok = TorchLoader(2, torch.device("cpu")).decide_all(srs, [(good, R), (mixed, R)])
    assert ok.dtype == torch.bool and ok.tolist() == [True, False]


def test_miller_loop_rejects_other_shapes():
    """The decide's Miller loop takes two pairs and one Z per point."""
    xs = torch.zeros((4, 2, 8), dtype=torch.int32)
    lines = torch.zeros((NSTEPS, 2, 3, 2, 8), dtype=torch.int32)
    fin = torch.zeros((2, 2, 3, 2, 8), dtype=torch.int32)
    no_add = np.zeros(NSTEPS, bool)
    xs3 = torch.zeros((4, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        miller_loop(xs3, xs3, xs3, lines, lines, no_add, fin)
    with pytest.raises(ValueError):
        miller_loop(xs, xs, xs[:2], lines, lines, no_add, fin)
    with pytest.raises(TypeError):
        miller_loop(xs, xs, None, lines, lines, no_add, fin)
