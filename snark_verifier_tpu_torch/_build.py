"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every csrc/*.cu (sources of this checkout only) for sm_90a,
one process per source, all started together, then links the objects into
one shared library in build/ inside the package (listed in .gitignore): a
plain C interface, no PyTorch headers, so a build takes seconds.  The
library name carries a hash of the sources, so an edited kernel is never
served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17"]
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry points of csrc/*.cu: name -> argtypes (all return a cudaError_t)
_SIGNATURES = {
    # msm_kernels.cu
    "svt_g1_add": [_P, _P, _P, _LL, _P],
    "svt_g1_double": [_P, _P, _LL, _P],
    "svt_fold_buckets": [_P, _P, _LL, _LL, _I, _P, _I, _P],
    # msm_loops.cu
    "svt_msm_windowed": [_P, _P, _LL, _I, _I, _I, _P, _P],
    "svt_bucket_reduce": [_P, _P, _P, _P],
    # fold_kernels.cu
    "svt_fold_segments": [_P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _P, _P],
    "svt_g1_add_chain": [_P, _P, _P, _LL, _I, _P],
    "svt_fq_mul_chain": [_P, _P, _P, _LL, _I, _I, _P],
    # field_kernels.cu
    "svt_field_mul": [_I, _P, _LL, _P, _LL, _P, _LL, _P],
    "svt_field_add": [_I, _P, _LL, _P, _LL, _P, _LL, _P],
    "svt_field_sub": [_I, _P, _LL, _P, _LL, _P, _LL, _P],
    "svt_field_neg": [_I, _P, _P, _LL, _P],
    "svt_field_inv": [_I, _P, _P, _LL, _P],
    "svt_field_canon": [_I, _P, _P, _LL, _P],
    "svt_points_to_fr": [_P, _I, _P, _LL, _P],
    # fr_tape.cu
    "svt_fr_tape": [_P, _I, _I, _P, _I, _P, _I, _P, _LL, _I, _P],
    # poseidon_kernels.cu
    "svt_poseidon_load_constants": [_P, _P],
    "svt_poseidon_permute": [_P, _P, _LL, _P],
    "svt_poseidon_absorb": [_P, _P, _I, _P, _LL, _P],
    # pairing_kernels.cu
    "svt_pairing_load_constants": [_P],
    "svt_miller_loop": [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P, _P],
    "svt_final_exp": [_P, _P, _I, _LL, _P, _P],
    "svt_fq12_op": [_I, _P, _P, _LL, _P, _P],
    # accumulation_kernels.cu
    "svt_fr_powers": [_P, _I, _P, _LL, _P],
    # ipa_kernels.cu
    "svt_ipa_h_coeffs": [_P, _I, _P, _P, _P],
    # keccak_kernels.cu
    "svt_keccak_read": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _LL,
                        _P],
}

_lib = None
build_log = ""  # nvcc/ptxas output of the build this process made (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _units():
    return sorted(SRC_DIR.glob("*.cu"))


def _sources():
    return _units() + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libsvt_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; raise with every failing one's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        msg = "\n".join(f"{' '.join(c)}\n  -> rc {rc}\n{o}" for c, rc, o in failed)
        raise RuntimeError(f"nvcc failed:\n{msg}")
    return "".join(outs)


def build() -> Path:
    """Compile and link csrc/*.cu unless these exact sources are built."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (u.stem + ".o") for u in _units()]
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(u)]
                        for u, o in zip(_units(), objs)])
        lib_tmp = Path(tmp) / out.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib_tmp), *map(str, objs)]])
        build_log = log
        os.replace(lib_tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
