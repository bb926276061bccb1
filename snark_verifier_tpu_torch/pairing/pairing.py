"""The BN254 pairing on the card: Miller loop over host-prepared G2 lines,
final exponentiation, pairing check.  The counterpart of the JAX package's
`pairing/pairing.py` (its positional path; the RNS branches exist for the
TPU's MXU and are not ported).

The KZG decider's G2 points are fixed SRS points, so their line
coefficients are prepared on the host (`prepare_g2_coeffs`,
py_pairing.prepare_g2) and the Miller loop is pure Fq12 arithmetic.

| wrapper | CUDA kernel (csrc/pairing_kernels.cu) | replaces (JAX package) | plain version |
| --- | --- | --- | --- |
| `miller_loop` | `svt_miller_loop` | `pairing/pairing.py::miller_loop` :151-164 with `_mul_lines` :99-117 | `miller_loop_plain` |
| `final_exponentiation` | `svt_final_exp` | `::final_exponentiation` :257-262 with `fq12_vm.run_tape` :145-160 | `final_exponentiation_plain` |
| `fq12_op` | `svt_fq12_op` | `tower/tower.py` :223-257, `::f12_frobenius` :213-232 | `fq12_op_plain` |

Values are int32 words (tower/encode.py's layouts).  Each wrapper checks
its arguments, launches its kernel for CUDA tensors (counting the launch
in `_launch.LAUNCHES`) and runs its plain version only for CPU tensors.
The plain versions run the tower of tower/tower.py on int64 limbs, on any
device; the kernels compute the same field elements (compare canonically:
the kernels skip multiplies by 1 and take conj12 as a negation).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .._build import load_library
from .._launch import check, launch, same_device
from ..ff import FQ_FIELD, limbs_to_words, np_limbs_to_words, words_to_limbs
from ..tower import FQ2, FQ6, FQ12
from ..tower.encode import fq_mont, tower_limbs
from . import fq12_vm
from . import py_pairing as pp

F = FQ_FIELD
NSTEPS = len(pp.NAF_DIGITS) - 1  # 65 Miller steps
NPAIRS = 2  # the KZG decide's pairs (lhs, g2) and (rhs, -s g2): the Miller kernel's
OPS = {"mul": 0, "square": 1, "mul_by_034": 2, "frob1": 3, "frob2": 4, "frob3": 5,
       "conj": 6, "inv": 7, "cyclo_square": 8}


# ------------------------------------------------------- host preparation


def prepare_pairs(pairs) -> Tuple:
    """Host: [(G1 affine int tuple, G2 affine int tuple)] -> numpy words.

    Returns (xs, ys, dbl, addc, has_add, finals):
      xs, ys  : (npairs, 8) Fq Montgomery words
      dbl     : (steps, npairs, 3, 2, 8) doubling-line coefficients
      addc    : (steps, npairs, 3, 2, 8) addition-line coefficients (zeros if none)
      has_add : (steps,) bool
      finals  : (2, npairs, 3, 2, 8) Frobenius end-step coefficients
    The same numbers as the JAX package's arrays, repacked into words."""
    npairs = len(pairs)
    xs = np_limbs_to_words(np.stack([fq_mont(p[0][0]) for p in pairs]))
    ys = np_limbs_to_words(np.stack([fq_mont(p[0][1]) for p in pairs]))
    all_coeffs = [pp.prepare_g2(q) for _, q in pairs]
    digits = list(reversed(pp.NAF_DIGITS[:-1]))
    steps = len(digits)
    dbl = np.zeros((steps, npairs, 3, 2, 16), np.uint32)
    addc = np.zeros((steps, npairs, 3, 2, 16), np.uint32)
    has_add = np.zeros((steps,), np.bool_)
    finals = np.zeros((2, npairs, 3, 2, 16), np.uint32)
    idx = [0] * npairs

    def take(k, kind):
        got, c = all_coeffs[k][idx[k]]
        assert got == kind
        idx[k] += 1
        return tower_limbs(c, 6)

    for i, d in enumerate(digits):
        for k in range(npairs):
            dbl[i, k] = take(k, "dbl")
        if d != 0:
            has_add[i] = True
            for k in range(npairs):
                addc[i, k] = take(k, "add")
    for j in range(2):
        for k in range(npairs):
            finals[j, k] = take(k, "add")
    return (xs, ys, np_limbs_to_words(dbl), np_limbs_to_words(addc), has_add,
            np_limbs_to_words(finals))


def prepare_g2_coeffs(qs) -> Tuple:
    """Host: fixed G2 points only -> (dbl, addc, has_add, finals), the layout
    of `prepare_pairs` (the G1 side comes at run time)."""
    fake_g1 = (1, 2)
    _, _, dbl, addc, has_add, finals = prepare_pairs([(fake_g1, q) for q in qs])
    return dbl, addc, has_add, finals


def coeffs_to_device(coeffs, device):
    """(dbl, addc, has_add, finals) numpy -> tensors on `device`; has_add
    stays a host bool array (the kernel takes it as a bitmask)."""
    dbl, addc, has_add, finals = coeffs
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return up(dbl), up(addc), np.asarray(has_add, np.bool_), up(finals)


# ----------------------------------------------------------- plain versions


def _mul_lines(f, coeffs, xs, ys, zs):
    """f *= Π_k line_k over limbs: coeffs (npairs, 3, 2, 16); xs, ys, zs
    (..., npairs, 16).  The line is evaluated at the projective point,
    scaled by Z (ℓ·Z = c·Y + c·X·w + c·Z·vw): the spurious Fq factor dies
    in the final exponentiation's easy part (Z = 1 for affine inputs)."""
    for k in range(coeffs.shape[-4]):
        c = coeffs[k]
        c0 = FQ2.smul(c[0], ys[..., k, :])
        c3 = FQ2.smul(c[1], xs[..., k, :])
        c4 = FQ2.smul(c[2], zs[..., k, :])
        f = FQ12.mul_by_034_sparse(f, c0, c3, c4)
    return f


def miller_loop_plain(xs, ys, zs, dbl, addc, has_add, finals):
    """The JAX package's positional multi-Miller loop in plain PyTorch on
    words: xs, ys, zs (B, npairs, 8) projective (Z = 1: affine), coefficient
    words as `prepare_g2_coeffs` gives them -> f (B, 2, 3, 2, 8) words.  Every
    step squares f (the first squares 1) and multiplies the dbl lines, then
    the add lines where has_add is set; the two Frobenius end steps last.
    The kernel's formulas: the complex Fq12 square and the sparse line
    product (the same field elements as the JAX package's generic ones)."""
    xs, ys, zs = (words_to_limbs(t) for t in (xs, ys, zs))
    dbl, addc, finals = (words_to_limbs(t) for t in (dbl, addc, finals))
    f = FQ12.one(xs.device).expand(*xs.shape[:-2], 2, 3, 2, 16)
    for i in range(dbl.shape[0]):
        f = FQ12.square_complex(f)
        f = _mul_lines(f, dbl[i], xs, ys, zs)
        if bool(has_add[i]):
            f = _mul_lines(f, addc[i], xs, ys, zs)
    f = _mul_lines(f, finals[0], xs, ys, zs)
    f = _mul_lines(f, finals[1], xs, ys, zs)
    return limbs_to_words(f)


@functools.lru_cache(maxsize=None)
def _frob_limbs(power: int):
    return tuple(tower_limbs(c, 2).astype(np.int64) for c in (
        pp.FROB_FQ6_C1[power % 6], pp.FROB_FQ6_C2[power % 6], pp.FROB_FQ12_C1[power % 12]))


def f12_frobenius(a, power: int):
    """a^(p^power) on Fq12 limbs (the JAX package's formula)."""
    k1, k2, k12 = (torch.from_numpy(k).to(a.device) for k in _frob_limbs(power))

    def f2_frob(x):
        return FQ2.conj(x) if power % 2 else x

    def f6_frob(x):
        return FQ6.make(f2_frob(x[..., 0, :, :]), FQ2.mul(f2_frob(x[..., 1, :, :]), k1),
                        FQ2.mul(f2_frob(x[..., 2, :, :]), k2))

    d0 = f6_frob(a[..., 0, :, :, :])
    d1 = f6_frob(a[..., 1, :, :, :])
    d1 = FQ6.make(*(FQ2.mul(d1[..., j, :, :], k12) for j in range(3)))
    return FQ12.make(d0, d1)


def final_exponentiation_plain(f):
    """(p^12 - 1)/r in plain PyTorch on words: the easy part conj(f)·f^-1,
    then the tape (fq12_vm.run_tape_plain) -> canonical words."""
    fl = words_to_limbs(f)
    m = FQ12.mul(FQ12.conj(fl), FQ12.inv(fl))  # f^(p^6 - 1)
    return limbs_to_words(F.canon(fq12_vm.final_exp_hard_plain(m)))


def fq12_op_plain(op: str, a, b=None):
    """The tower operation `op` (an OPS key) in plain PyTorch on words, by
    the kernel's formulas: a (B, 2, 3, 2, 8); b (B, 2, 3, 2, 8) for mul,
    (B, 3, 2, 8) = (c0, c3, c4) for mul_by_034.  `cyclo_square` is the
    square only for a in the cyclotomic subgroup."""
    al = words_to_limbs(a)
    if op == "mul":
        r = FQ12.mul(al, words_to_limbs(b))
    elif op == "square":
        r = FQ12.square_complex(al)
    elif op == "cyclo_square":
        r = FQ12.cyclotomic_square(al)
    elif op == "mul_by_034":
        bl = words_to_limbs(b)
        r = FQ12.mul_by_034_sparse(al, bl[..., 0, :, :], bl[..., 1, :, :], bl[..., 2, :, :])
    elif op in ("frob1", "frob2", "frob3"):
        r = f12_frobenius(al, int(op[-1]))
    elif op == "conj":
        r = FQ12.conj(al)
    elif op == "inv":
        r = FQ12.inv(al)
    else:
        raise ValueError(f"fq12_op: unknown op {op!r}")
    return limbs_to_words(r)


# ------------------------------------------------------------------- kernels

_loaded: set = set()  # CUDA devices whose constant memory holds the Frobenius table


def _library(device):
    lib = load_library()
    if str(device) not in _loaded:
        tab = np.ascontiguousarray(fq12_vm.transform_table())
        with torch.cuda.device(device):
            err = lib.svt_pairing_load_constants(tab.ctypes.data)
        if err:
            raise RuntimeError(f"pairing: loading the constants failed ({err})")
        _loaded.add(str(device))
    return lib


def _fq12_check(name, t):
    check(name, t, 5, (2, 3, 2, 8))


def _mask(has_add):
    bits = np.asarray(has_add, np.bool_)
    if bits.shape != (NSTEPS,):
        raise ValueError(f"miller_loop: has_add must have {NSTEPS} steps, got {bits.shape}")
    words = [sum(1 << i for i in range(64) if j + i < NSTEPS and bits[j + i])
             for j in (0, 64)]
    return [w - (1 << 64) if w >= 1 << 63 else w for w in words]  # as signed long long


def miller_loop(xs, ys, zs, dbl, addc, has_add, finals):
    """Multi-Miller loop of B lanes over the decide's two pairs: xs, ys, zs
    (B, 2, 8) projective Fq words (Z = 1: affine); dbl, addc (65, 2, 3, 2,
    8) and finals (2, 2, 3, 2, 8) line words shared by the batch; has_add
    (65,) host bools -> f (B, 2, 3, 2, 8).  On the card one launch of
    `svt_miller_loop`; on the CPU `miller_loop_plain`."""
    for t in (xs, ys, zs):
        check("miller_loop", t, 3, (NPAIRS, 8))
    if not xs.shape == ys.shape == zs.shape:
        raise ValueError("miller_loop: xs, ys and zs differ in shape")
    for t in (dbl, addc):
        check("miller_loop", t, 5, (NPAIRS, 3, 2, 8))
        if t.shape[0] != NSTEPS:
            raise ValueError(f"miller_loop: {t.shape[0]} line steps, want {NSTEPS}")
    check("miller_loop", finals, 5, (2, NPAIRS, 3, 2, 8))
    same_device("miller_loop", xs, ys, zs, dbl, addc, finals)
    if xs.device.type == "cpu":
        return miller_loop_plain(xs, ys, zs, dbl, addc, has_add, finals)
    lo, hi = _mask(has_add)
    B = xs.shape[0]
    out = torch.empty((B, 2, 3, 2, 8), dtype=torch.int32, device=xs.device)
    if B:
        launch("miller_loop", _library(xs.device).svt_miller_loop, xs.data_ptr(),
               ys.data_ptr(), zs.data_ptr(), dbl.data_ptr(), addc.data_ptr(),
               finals.data_ptr(), lo, hi, B, out.data_ptr(), device=xs.device)
    return out


@functools.lru_cache(maxsize=None)
def _tape_dev(device: str):
    return torch.from_numpy(fq12_vm.build_final_exp_tape()).to(device)


def final_exponentiation(f):
    """f^((p^12 - 1)/r) of (B, 2, 3, 2, 8) words -> canonical words.  On
    the card one launch of `svt_final_exp` (the easy part, then the tape);
    on the CPU `final_exponentiation_plain`."""
    _fq12_check("final_exp", f)
    if f.device.type == "cpu":
        return final_exponentiation_plain(f)
    tape = _tape_dev(str(f.device))
    out = torch.empty_like(f)
    if f.shape[0]:
        launch("final_exp", _library(f.device).svt_final_exp, f.data_ptr(), tape.data_ptr(),
               tape.shape[0], f.shape[0], out.data_ptr(), device=f.device)
    return out


def fq12_op(op: str, a, b=None):
    """One tower operation per launch of `svt_fq12_op` (its plain version
    on the CPU): the card's tool for finding which tower function a path
    kernel gets wrong.  Shapes as `fq12_op_plain`; lazy words out."""
    if op not in OPS:
        raise ValueError(f"fq12_op: unknown op {op!r}")
    _fq12_check("fq12_op", a)
    if op == "mul":
        check("fq12_op", b, 5, (2, 3, 2, 8))
    elif op == "mul_by_034":
        check("fq12_op", b, 4, (3, 2, 8))
    elif b is not None:
        raise ValueError(f"fq12_op: {op} takes one operand")
    if b is not None:
        same_device("fq12_op", a, b)
        if b.shape[0] != a.shape[0]:
            raise ValueError("fq12_op: operands differ in batch")
    if a.device.type == "cpu":
        return fq12_op_plain(op, a, b)
    out = torch.empty_like(a)
    if a.shape[0]:
        launch("fq12_op", _library(a.device).svt_fq12_op, OPS[op], a.data_ptr(),
               (b if b is not None else a).data_ptr(), a.shape[0], out.data_ptr(),
               device=a.device)
    return out


# ------------------------------------------------------------------- check


@functools.lru_cache(maxsize=None)
def _one12_words(device: str):
    one = np.zeros((2, 3, 2, 16), np.uint32)
    one[0, 0, 0] = fq_mont(1)
    return torch.from_numpy(np_limbs_to_words(one)).to(device)


def is_one(fe):
    """Canonical (..., 2, 3, 2, 8) words == 1, a word compare."""
    return (fe == _one12_words(str(fe.device))).flatten(-4).all(-1)


def pairing_check(xs, ys, zs, coeffs):
    """Π_k e(P_k, Q_k) == 1 for each of B lanes: xs, ys, zs (B, npairs, 8)
    projective G1 words (the lines scaled by Z, which the final
    exponentiation kills), coeffs the Q's (dbl, addc, has_add, finals) on
    the same device -> (B,) bool."""
    dbl, addc, has_add, finals = coeffs
    f = miller_loop(xs, ys, zs, dbl, addc, has_add, finals)
    return is_one(final_exponentiation(f))
