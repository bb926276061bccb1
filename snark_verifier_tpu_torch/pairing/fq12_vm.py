"""The final exponentiation's hard part as a tape of Fq12 register-machine
steps: the counterpart of the JAX package's `pairing/fq12_vm.py`.

A step is

    t      = transform(R[src1])     # identity, conj12, or frobenius^k
    R[dst] = t * R[src2]            # one Fq12 multiply

over NREG Fq12 registers; register R_ONE always holds 1, so a multiply by
it makes a pure transform or a copy.  The JAX package stores each step's
transform as (conj flag, six Fq2 coefficients): (406, 6, 2, 16) limbs, too
large for the card's constant memory.  Only four transforms occur, so the
port's tape is (n, 4) int32 rows (src1, src2, dst, transform id) and the
coefficient sets are a table of their own (`transform_table`), which
csrc/pairing_kernels.cu keeps in __constant__ memory.  `expand_tape` turns
the port's tape back into the JAX package's arrays.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..ff import np_limbs_to_words
from ..ff.spec import FQ
from ..tower import FQ2, FQ12
from ..tower.encode import fq_mont
from . import py_pairing as pp

NREG = 8
R_ONE = 0  # always holds 1

# Transform ids: the tape uses the first four; frobenius^3 serves
# svt_fq12_op's FROB3 code.
T_IDENTITY, T_CONJ12, T_FROB1, T_FROB2, T_FROB3 = range(5)
_FROB_IDS = {1: T_FROB1, 2: T_FROB2, 3: T_FROB3}


def _coeff_identity():
    return [(1, 0)] * 6


def _coeff_conj12():
    # conjugate in Fq12 = negate the c1 (w) part: coords 3, 4, 5 scaled by -1
    one, neg1 = (1, 0), (FQ.p - 1, 0)
    return [one, one, one, neg1, neg1, neg1]


def _coeff_frob(power: int):
    c1 = pp.FROB_FQ6_C1[power % 6]
    c2 = pp.FROB_FQ6_C2[power % 6]
    c12 = pp.FROB_FQ12_C1[power % 12]
    f2m = pp.f2_mul
    return [(1, 0), c1, c2, c12, f2m(c1, c12), f2m(c2, c12)]


def transform(tid: int):
    """(conj flag, six Fq2 int coefficients) of transform `tid`."""
    if tid == T_IDENTITY:
        return False, _coeff_identity()
    if tid == T_CONJ12:
        return False, _coeff_conj12()
    power = {T_FROB1: 1, T_FROB2: 2, T_FROB3: 3}[tid]
    return bool(power % 2), _coeff_frob(power)


def _coeff_limbs(coeffs) -> np.ndarray:
    return np.stack([np.stack([fq_mont(c[0]), fq_mont(c[1])]) for c in coeffs])  # (6, 2, 16)


@functools.lru_cache(maxsize=None)
def transform_table() -> np.ndarray:
    """(3, 6, 2, 8) int32 Montgomery words: the coefficient sets of
    frobenius^1, ^2 and ^3, the kernels' __constant__ table (conj12 is a
    negation there, the identity nothing)."""
    tab = np.stack([_coeff_limbs(transform(t)[1]) for t in (T_FROB1, T_FROB2, T_FROB3)])
    return np_limbs_to_words(tab)


class TapeBuilder:
    """Host-side builder of a straight-line Fq12 program (the JAX package's
    TapeBuilder, recording transform ids)."""

    def __init__(self):
        self.rows: List[tuple] = []

    def emit(self, dst: int, src1: int, src2: int = R_ONE, tid: int = T_IDENTITY):
        self.rows.append((src1, src2, dst, tid))

    def mul(self, dst, a, b):
        self.emit(dst, a, b)

    def square(self, dst, a):
        self.emit(dst, a, a)

    def conj12(self, dst, a):
        self.emit(dst, a, R_ONE, T_CONJ12)

    def frob(self, dst, a, power: int):
        self.emit(dst, a, R_ONE, _FROB_IDS[power])

    def pow_x(self, dst, base, x: int):
        """dst <- base^x by square-and-multiply (dst must differ from base)."""
        bits = bin(x)[2:]
        self.mul(dst, base, R_ONE)  # dst = base (the leading 1 bit)
        for b in bits[1:]:
            self.square(dst, dst)
            self.mul(dst, dst, base if b == "1" else R_ONE)

    def array(self) -> np.ndarray:
        """(n, 4) int32 rows (src1, src2, dst, transform id)."""
        return np.array(self.rows, np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=None)
def build_final_exp_tape() -> np.ndarray:
    """The whole post-inversion program.  Precondition: R[1] = conj(f)·f^-1
    (=: m).  Postcondition: R[1] = the final exponentiation of f."""
    t = TapeBuilder()
    M, A, B, C, E, T = 1, 2, 3, 4, 5, 6
    x = pp.X
    # easy part tail: m = frob2(m) * m
    t.frob(A, M, 2)
    t.mul(M, A, M)
    # fu = m^x (A), fu2 = fu^x (B), fu3 = fu2^x (C)
    t.pow_x(A, M, x)
    t.pow_x(B, A, x)
    t.pow_x(C, B, x)
    # y6 = conj(fu3 * frob1(fu3)) -> C
    t.frob(T, C, 1)
    t.mul(C, C, T)
    t.conj12(C, C)
    # t0 = y6^2 * y4 * y5 ;  y4 = conj(fu * frob1(fu2)), y5 = conj(fu2)
    t.square(C, C)
    t.frob(T, B, 1)
    t.mul(T, A, T)
    t.conj12(T, T)
    t.mul(C, C, T)
    t.conj12(E, B)
    t.mul(C, C, E)
    # t1 = y3 * y5 * t0 ; y3 = conj(frob1(fu))
    t.frob(T, A, 1)
    t.conj12(T, T)
    t.mul(T, T, E)
    t.mul(T, T, C)
    # t0 = t0 * y2 ; y2 = frob2(fu2)
    t.frob(E, B, 2)
    t.mul(C, C, E)
    # t1 = t1² · t0 ; t1 = t1²
    t.square(T, T)
    t.mul(T, T, C)
    t.square(T, T)
    # t0' = t1 * y1 ; y1 = conj(m)
    t.conj12(E, M)
    t.mul(E, T, E)
    # t1 = t1 * y0 ; y0 = fp·fp2·fp3 of m
    t.frob(A, M, 1)
    t.frob(B, M, 2)
    t.mul(A, A, B)
    t.frob(B, B, 1)
    t.mul(A, A, B)
    t.mul(T, T, A)
    # result = (t0')² * t1
    t.square(E, E)
    t.mul(M, E, T)
    return t.array()


def expand_tape(tape):
    """The port's (n, 4) tape -> the JAX package's arrays (src1, src2, dst,
    conj, coeffs (n, 6, 2, 16) uint32 limbs)."""
    tape = np.asarray(tape)
    sets = {tid: transform(tid) for tid in set(tape[:, 3].tolist())}
    conj = np.array([sets[t][0] for t in tape[:, 3]], np.bool_)
    coeffs = np.stack([_coeff_limbs(sets[t][1]) for t in tape[:, 3]]).astype(np.uint32)
    return (tape[:, 0].copy(), tape[:, 1].copy(), tape[:, 2].copy(), conj, coeffs)


def run_tape_plain(regs: list, tape) -> list:
    """The JAX scan body in plain PyTorch: regs is a list of NREG Fq12 limb
    tensors (..., 2, 3, 2, 16); each step transforms R[src1] (optional Fq2
    conjugation of every coordinate, then an Fq2 coefficient product per
    coordinate, the identity included) and multiplies it by R[src2], both
    read before R[dst] is written.  Returns the updated list."""
    src1, src2, dst, conj, coeffs = expand_tape(tape)
    regs = list(regs)
    dev = regs[0].device
    co_dev = {}
    for s1, s2, d, cj, co in zip(src1, src2, dst, conj, coeffs):
        key = co.tobytes()
        if key not in co_dev:
            co_dev[key] = torch.from_numpy(co.astype(np.int64)).to(dev)
        a, b = regs[s1], regs[s2]
        flat = a.reshape(*a.shape[:-4], 6, 2, 16)
        if cj:
            flat = FQ2.conj(flat)
        t = FQ2.mul(flat, co_dev[key]).reshape(a.shape)
        regs[d] = FQ12.mul(t, b)
    return regs


def final_exp_hard_plain(m_limbs):
    """R[1] = m, the rest 1; run the tape; return R[1] (limbs, lazy)."""
    one = FQ12.one(m_limbs.device).expand(m_limbs.shape)
    regs = [one] * NREG
    regs[1] = m_limbs
    return run_tape_plain(regs, build_final_exp_tape())[1]

