"""ctypes bindings for the native C++ BN254 host core: the port's copy of
the JAX package's `utils/native.py`, over the port's own copy of the source,
`csrc/host/bn254.cpp`.

The library is built at first use with g++ and the flags of the repository's
csrc/Makefile into the package's build/ directory (listed in .gitignore),
under a name that carries a hash of the source and the flags, as `_build.py`
names the CUDA library; the repository's csrc/libbn254.so is never touched.
`_build.py` globs only the top level of csrc/, so nvcc never sees this file.
It is an independent host oracle (msm, scalar_mul, srs_powers, the
multithreaded MSM, the host slot assignment) that no path of the port calls:
the port's commitments run as `msm` on the card, or as `py_ec.msm` on the
CPU.  Where there is no compiler, `available()` is False.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ff.spec import FQ, FR

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "bn254.cpp"
BUILD_DIR = _PKG / "build"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=x86-64-v3", "-pthread"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libbn254_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/host/bn254.cpp with g++ unless this exact source is built."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native host core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = Path(tmp) / out.name
        subprocess.run([cxx, *CXXFLAGS, "-o", str(lib_tmp), str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(lib_tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _limbs64(x: int) -> np.ndarray:
    return np.array([(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)], np.uint64)


def _from64(a) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(a))


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    R = 1 << 256

    def mont_params(p):
        r2 = _limbs64(R * R % p)
        ninv = (-pow(p, -1, 1 << 64)) % (1 << 64)
        one = _limbs64(R % p)
        return _limbs64(p), r2, ninv, one

    qp, qr2, qninv, qone = mont_params(FQ.p)
    rp, rr2, rninv, rone = mont_params(FR.p)
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    lib.bn254_init.argtypes = [u64p, u64p, ctypes.c_uint64, u64p] * 2
    lib.bn254_init(qp, qr2, qninv, qone, rp, rr2, rninv, rone)
    lib.bn254_msm.argtypes = [u64p, u64p, ctypes.c_long, u64p]
    lib.bn254_scalar_mul.argtypes = [u64p, u64p, u64p]
    lib.bn254_srs_powers.argtypes = [u64p, u64p, ctypes.c_long, u64p]
    lib.bn254_enumerate_points.argtypes = [u64p, ctypes.c_long, u64p]
    lib.bn254_fe_mul_batch.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_long]
    lib.bn254_fe_inv_batch.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
    lib.bn254_msm_mt.argtypes = [u64p, u64p, ctypes.c_long, ctypes.c_int, u64p]
    i32nd = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.bn254_slot_indices.argtypes = [
        u64p, ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, i32nd, i32nd, i32nd, ctypes.c_int,
    ]
    for name in ("bn254_init", "bn254_msm", "bn254_scalar_mul", "bn254_srs_powers",
                 "bn254_enumerate_points", "bn254_fe_mul_batch", "bn254_fe_inv_batch",
                 "bn254_msm_mt", "bn254_slot_indices"):
        getattr(lib, name).restype = None  # every entry point returns void
    return lib


def available() -> bool:
    """True where the host core builds and loads (a host with g++)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host core is not available (no g++ build)")
    return lib


def _enc_point(pt) -> np.ndarray:
    """affine int tuple (or None) -> 12 u64 Montgomery projective limbs."""
    R = 1 << 256
    out = np.zeros(12, np.uint64)
    if pt is None:
        out[4:8] = _limbs64(R % FQ.p)  # (0:1:0)
        return out
    out[0:4] = _limbs64(pt[0] * R % FQ.p)
    out[4:8] = _limbs64(pt[1] * R % FQ.p)
    out[8:12] = _limbs64(R % FQ.p)
    return out


def _dec_point(buf) -> Optional[Tuple[int, int]]:
    Rinv = pow(1 << 256, -1, FQ.p)
    x = _from64(buf[0:4]) * Rinv % FQ.p
    y = _from64(buf[4:8]) * Rinv % FQ.p
    z = _from64(buf[8:12]) * Rinv % FQ.p
    if z == 0:
        return None
    zi = pow(z, -1, FQ.p)
    return (x * zi % FQ.p, y * zi % FQ.p)


def msm(points: List, scalars: List[int]):
    """Native Pippenger MSM over affine int points; returns affine tuple."""
    lib = _lib()
    n = len(points)
    pts = np.concatenate([_enc_point(p) for p in points])
    scs = np.concatenate([_limbs64(int(s) % FR.p) for s in scalars])
    out = np.zeros(12, np.uint64)
    lib.bn254_msm(np.ascontiguousarray(pts), np.ascontiguousarray(scs), n, out)
    return _dec_point(out)


def msm_mt_dev(points_u64: np.ndarray, scalars_u64: np.ndarray,
               nthreads: int = 0):
    """Multithreaded Pippenger on pre-encoded buffers (n*12 / n*4 u64 limbs,
    Montgomery projective points, plain scalars): the host's rate, the
    counterpart of the reference's rayon MSM (util/msm.rs:290-310).  Returns
    the 12-limb result buffer."""
    lib = _lib()
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    n = len(scalars_u64) // 4
    out = np.zeros(12, np.uint64)
    lib.bn254_msm_mt(
        np.ascontiguousarray(points_u64), np.ascontiguousarray(scalars_u64),
        n, nthreads, out,
    )
    return out


def msm_mt(points: List, scalars: List[int], nthreads: int = 0):
    """Multithreaded MSM over affine int points; returns affine tuple."""
    pts = np.concatenate([_enc_point(p) for p in points])
    scs = np.concatenate([_limbs64(int(s) % FR.p) for s in scalars])
    return _dec_point(msm_mt_dev(pts, scs, nthreads))


def scalar_mul(point, k: int):
    lib = _lib()
    out = np.zeros(12, np.uint64)
    lib.bn254_scalar_mul(_enc_point(point), _limbs64(int(k) % FR.p), out)
    return _dec_point(out)


def enumerate_points_dev(n: int):
    """[1..n]*G as an (n, 3, 16) uint32 array of 16-bit Montgomery limbs,
    the layout `msm.msm` takes.  Native C++ sequential adds + a pure-numpy
    limb reshuffle."""
    lib = _lib()

    out = np.zeros(12 * n, np.uint64)
    lib.bn254_enumerate_points(_enc_point((1, 2)), n, out)
    # u64 Montgomery projective limbs -> 16x16-bit-in-u32 little-endian
    u16 = out.reshape(n, 3, 4).view(np.uint16)  # (n, 3, 16), little-endian
    return u16.astype(np.uint32)


def enumerate_points_raw(n: int) -> np.ndarray:
    """[1..n]*G as the raw n*12 u64 Montgomery projective buffer (the direct
    input format of msm_mt_dev)."""
    lib = _lib()
    out = np.zeros(12 * n, np.uint64)
    lib.bn254_enumerate_points(_enc_point((1, 2)), n, out)
    return out


def srs_powers(g, tau: int, n: int) -> List:
    """[tau^i]G for i in 0..n-1."""
    lib = _lib()
    out = np.zeros(12 * n, np.uint64)
    lib.bn254_srs_powers(_enc_point(g), _limbs64(tau % FR.p), n, out)
    return [_dec_point(out[12 * i : 12 * (i + 1)]) for i in range(n)]


def slot_indices(scalars_u64: np.ndarray, c: int, cap: int, trange: int,
                 tcap: int, nthreads: int = 0):
    """Host Pippenger slot assignment (bn254_slot_indices): scalars (n, 4)
    u64 LE -> (idx_main (W-1, 2^c, cap) i32, idx_top (trange, tcap) i32,
    overflow bool), with n as the sentinel index: the host counterpart of
    `msm.pippenger._slot_indices`."""
    lib = _lib()
    n = scalars_u64.shape[0]
    W = (256 + c - 1) // c
    nb = 1 << c
    sc = np.ascontiguousarray(scalars_u64.reshape(-1).astype(np.uint64))
    idx_main = np.empty((W - 1) * nb * cap, np.int32)
    idx_top = np.empty(trange * tcap, np.int32)
    ovf = np.zeros(1, np.int32)
    lib.bn254_slot_indices(
        sc, n, c, cap, trange, tcap, idx_main, idx_top, ovf,
        nthreads or (os.cpu_count() or 1),
    )
    return (idx_main.reshape(W - 1, nb, cap), idx_top.reshape(trange, tcap),
            bool(ovf[0]))
