"""BN254 G1: curve instance, host-side encode/decode, and the two point
layouts of the port.

* The JAX package's layout, used at every public function: (..., 3, 16)
  homogeneous projective X, Y, Z over Fq, each 16 little-endian 16-bit limbs
  of the Montgomery form x·R mod p (R = 2^256); infinity is (0 : 1 : 0).
  In the port these are int64 tensors (`LimbField`).
* The kernels' layout: (..., 3, 8) int32 tensors whose bits are the same
  numbers as 8 little-endian 32-bit words.  R = 2^256 whatever the limb
  width, so the two layouts hold the very same values, repacked.

`from_jax_points` / `to_jax_points` carry points between the JAX package
and the port's kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ff import FQ, FQ_FIELD, NLIMBS, limbs_to_words, np_limbs_to_words, words_to_limbs
from ..ff.spec import BN254_B, int_to_limbs, limbs_to_int
from .curve import CurveOps

G1 = CurveOps(FQ_FIELD, b=BN254_B, name="bn254_g1")

NWORDS = 8  # 32-bit words per coordinate in the kernels' layout


def from_jax_points(points, device=None):
    """JAX-package points (np.ndarray or tensor, (..., 3, 16) 16-bit limbs,
    e.g. uint32) -> the kernels' (..., 3, 8) int32 words on `device`
    (None: the CUDA card)."""
    if isinstance(points, np.ndarray):
        points = torch.from_numpy(points.astype(np.int64))
    return limbs_to_words(points.to(resolve_device(device)))


def to_jax_points(words):
    """The kernels' (..., 3, 8) int32 words -> (..., 3, 16) uint32 numpy,
    the JAX package's point layout."""
    return words_to_limbs(words).cpu().numpy().astype(np.uint32)


# ------------------------------------------------------------------ encoding


def from_affine_int(pts, device="cpu"):
    """Host: affine (x, y) int tuples (None = infinity) -> (n, 3, 16) int64
    projective Montgomery limbs on `device`."""
    p, R = FQ.p, 1 << 256
    out = np.zeros((len(pts), 3, NLIMBS), dtype=np.int64)
    for i, pt in enumerate(pts):
        if pt is None:
            out[i, 1] = int_to_limbs(R % p)  # (0 : 1 : 0)
            continue
        x, y = pt
        out[i, 0] = int_to_limbs(x * R % p)
        out[i, 1] = int_to_limbs(y * R % p)
        out[i, 2] = int_to_limbs(R % p)  # Z = 1 in Montgomery form
    return torch.as_tensor(out, device=device)


def from_affine_int_np(pts) -> np.ndarray:
    """Host: affine (x, y) int tuples (None = infinity) -> (n, 3, 8) int32
    projective Montgomery words in numpy, ready for one upload."""
    return np_limbs_to_words(from_affine_int(pts).numpy())


def to_affine_int(pt):
    """Host: (..., 3, 16) projective limbs (tensor or numpy) -> affine int
    tuples (None = infinity); a single point for a (3, 16) input."""
    p, R = FQ.p, 1 << 256
    rinv = pow(R, -1, p)
    arr = pt.detach().cpu().numpy() if isinstance(pt, torch.Tensor) else np.asarray(pt)
    out = []
    for row in arr.reshape(-1, 3, NLIMBS):
        x, y, z = (limbs_to_int(row[k]) * rinv % p for k in range(3))
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, p)
        out.append((x * zi % p, y * zi % p))
    return out[0] if arr.ndim == 2 else out


def generator(device="cpu"):
    return from_affine_int([(1, 2)], device=device)[0]
