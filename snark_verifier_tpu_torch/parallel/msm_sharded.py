"""The MSM over a mesh of devices: the port's counterpart of the JAX
package's `parallel/msm_sharded.py` (`_tree_fold` :27, `batch_msm_sharded`
:43, `msm_sharded` :75).

An MSM is linear over subsets of its points, so each device runs the port's
`msm` on its shard of the points (`svt_fold_buckets`, `svt_fold_segments`,
`svt_bucket_reduce`), the (3, 8)-word partial sums and overflow flags are
gathered onto one device (`mesh.all_gather`), and a halving fold adds them,
one `svt_g1_add` launch a level, ceil(log2 D) in all.  The JAX package
switches to `msm_rns` at n / D >= 4096; the port's `msm` serves both sizes.
torch has no replicated tensor: the result lands on the mesh's first device
(every replica of the JAX package holds the same value).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ec.g1 import limbs_to_words, words_to_limbs
from ..msm import cuda_ops
from ..msm.pippenger import msm
from .mesh import Mesh, all_gather, assemble, shard_bounds


def _tree_fold(parts):
    """Halving fold of (D, ..., 3, 8) points along dim 0 (odd widths carry
    their last part): one `cuda_ops.add` a level over every trailing lane."""
    width = parts.shape[0]
    while width > 1:
        half = width // 2
        lo, hi = parts[:half], parts[half:width]
        s = cuda_ops.add(lo.reshape(-1, 3, 8).contiguous(),
                         hi[:half].reshape(-1, 3, 8).contiguous()).view(lo.shape)
        parts = torch.cat([s, hi[half:]], 0) if width % 2 else s
        width = parts.shape[0]
    return parts[0]


def batch_msm_sharded(points, scalars_u16, mesh: Mesh, batch_axis: str = "batch",
                      points_axis: str = "points", capacity: Optional[int] = None):
    """B MSMs over a 2-d mesh: data-parallel over `batch_axis`, the points
    of each MSM sharded over `points_axis`.  points (B, n, 3, 16), scalars
    (B, n, 16) (the `msm` layouts); B and n must divide by the axes' sizes;
    capacity None is `msm`'s default at the shard's size.
    Each device runs its MSMs one after another (the JAX package's `vmap`).
    Returns ((B, 3, 16) int64 limbs, (B,) overflow), on the mesh's first
    device."""
    if mesh.devices.ndim != 2:
        raise ValueError(f"batch_msm_sharded: a 2-d mesh, not {mesh.shape}")
    kb, kp = mesh.axis(batch_axis), mesh.axis(points_axis)
    B, n = points.shape[0], points.shape[1]
    b_slices = shard_bounds(B, mesh, batch_axis)
    p_slices = shard_bounds(n, mesh, points_axis)
    parts = np.empty(mesh.devices.shape, dtype=object)
    flags = np.empty(mesh.devices.shape, dtype=object)
    for pos, dev in np.ndenumerate(mesh.devices):
        ps = p_slices[pos[kp]]
        outs = [msm(points[b, ps], scalars_u16[b, ps], capacity=capacity, device=dev)
                for b in range(B)[b_slices[pos[kb]]]]
        parts[pos] = torch.stack([limbs_to_words(r) for r, _ in outs], 0)  # (Bl, 3, 8)
        flags[pos] = torch.stack([o for _, o in outs], 0)
    sums = all_gather(parts, mesh, points_axis)  # over the batch axis: (D, Bl, 3, 8) each
    ovfs = all_gather(flags, mesh, points_axis)
    out = assemble([words_to_limbs(_tree_fold(s)) for s in sums.flat], mesh)
    return out, assemble([o.any(0) for o in ovfs.flat], mesh)


def msm_sharded(points, scalars_u16, mesh: Mesh, axis_name: str = "points",
                capacity: Optional[int] = None):
    """Σ sᵢ·Pᵢ across mesh axis `axis_name`.  points (n, 3, 16), scalars
    (n, 16); n must divide by the axis's size (pad with zero scalars);
    capacity None is `msm`'s default at the shard's size.
    Returns (result (3, 16) int64 limbs, overflow flag), on the mesh's first
    device."""
    line = mesh.along(axis_name)
    slices = shard_bounds(points.shape[0], line, axis_name)
    outs = [msm(points[s], scalars_u16[s], capacity=capacity, device=dev)
            for s, dev in zip(slices, line.devices.flat)]
    sums = all_gather([limbs_to_words(r) for r, _ in outs], line, axis_name).item()
    ovf = all_gather([o for _, o in outs], line, axis_name).item().any()
    return words_to_limbs(_tree_fold(sums)), ovf
