"""A mesh of devices and the one collective the sharded paths use: the
port's counterpart of `jax.sharding.Mesh` and of `jax.lax.all_gather`
inside `shard_map`.

The design is single-controller, as `shard_map` is: one process drives
every device of the mesh, shard after shard, from the host.  A mesh is a
numpy array of indexed `torch.device`s with a name per axis; a device may
repeat, so a mesh of one card listed D times runs every shard on that card
(how the sharded paths are checked on a host with one card, and on the CPU
with `["cpu"] * D`).

`all_gather` is the only place data moves between the shards: it copies
each shard's tensor onto the gathering device (`tensor.to(device)`: a peer
copy over NVLink when the mesh spans several cards, a same-device copy
otherwise) and records the gather while a `recording()` is open.  A gather
from a device to itself is recorded too: the inventory counts logical bytes,
as XLA's does for `all_gather`.  A later PR on a host with several cards may
route this one function through NCCL (`torch.distributed`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device

_DTYPE_NAMES = {torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}  # XLA's names
_RECORDS: List[List[Dict]] = []  # the open recordings, innermost last


class Mesh:
    """devices: an array (any nesting) of devices or device names, one axis
    per name in `axis_names`.  Every entry is resolved to an indexed device
    (`resolve_device`): a CUDA entry that names a missing card raises."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(names):
            raise ValueError(f"Mesh: {arr.ndim}-d devices for the axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"Mesh: repeated axis name in {names}")
        if arr.size == 0:
            raise ValueError("Mesh: no device")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos, d in np.ndenumerate(arr):
            self.devices[pos] = resolve_device(d)
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The device that holds a replicated result."""
        return self.devices.flat[0]

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"Mesh: no axis {name!r} in {self.axis_names}")
        return self.axis_names.index(name)

    def along(self, name: str) -> "Mesh":
        """The 1-d mesh of the devices along axis `name`, the other axes at
        position 0 (their replicas compute the same values, so the port
        runs one)."""
        k = self.axis(name)
        return Mesh(np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k], -1)[:, 0],
                    (name,))

    def synchronize(self):
        """Wait for every CUDA device of the mesh (each physical card once)."""
        for d in {str(d): d for d in self.devices.flat if d.type == "cuda"}.values():
            torch.cuda.synchronize(d)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def shard_bounds(n: int, mesh: Mesh, axis: str) -> List[slice]:
    """The contiguous slices of an axis of length n over mesh axis `axis`,
    one a device in order.  Raises ValueError unless n divides evenly (the
    JAX package asserts)."""
    ndev = mesh.devices.shape[mesh.axis(axis)]
    if n % ndev:
        raise ValueError(f"{n} not divisible by mesh axis {axis!r} of {ndev} devices")
    step = n // ndev
    return [slice(i * step, (i + 1) * step) for i in range(ndev)]


def split(x, mesh: Mesh, axis: str) -> List:
    """x (a list, or a tensor along dim 0) cut into the shards of mesh axis
    `axis`, each a sub-list or a view (not yet on its device)."""
    return [x[s] for s in shard_bounds(len(x), mesh, axis)]


@contextlib.contextmanager
def recording():
    """Record every `all_gather` inside the block: yields the list that
    receives one {op, type, bytes} entry a gather."""
    ops: List[Dict] = []
    _RECORDS.append(ops)
    try:
        yield ops
    finally:
        _RECORDS.remove(ops)


def _type(t: torch.Tensor) -> str:
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


def all_gather(parts, mesh: Mesh, axis: str):
    """Gather along mesh axis `axis`: parts is an object array of the mesh's
    shape (or a list, for a 1-d mesh) with one tensor a device, all of one
    shape and dtype.  Each group of devices along `axis` gets its tensors
    stacked on a new dim 0 on the group's first device.  Returns an object
    array over the other axes (a 0-d array for a 1-d mesh: `.item()`).
    Recorded as one all-gather of the stacked shape, as the JAX package's
    inventory lists one op for every group of an SPMD program."""
    arr = _as_object_array(parts, mesh)
    k = mesh.axis(axis)
    moved = np.moveaxis(arr, k, -1)
    devs = np.moveaxis(mesh.devices, k, -1)
    out = np.empty(moved.shape[:-1], dtype=object)
    for pos in np.ndindex(*out.shape):
        dst = devs[pos][0]
        out[pos] = torch.stack([t.to(dst) for t in moved[pos]], 0)
    first = out.flat[0]
    for ops in _RECORDS:
        ops.append({"op": "all-gather", "type": _type(first),
                    "bytes": first.numel() * first.element_size()})
    return out


def _as_object_array(parts, mesh: Mesh) -> np.ndarray:
    arr = np.empty(mesh.devices.shape, dtype=object)
    flat = list(parts.flat) if isinstance(parts, np.ndarray) else list(parts)
    if len(flat) != mesh.size:
        raise ValueError(f"all_gather: {len(flat)} parts for a mesh of {mesh.size} devices")
    for i, t in enumerate(flat):
        arr.flat[i] = t
    shapes = {(tuple(t.shape), t.dtype) for t in flat}
    if len(shapes) != 1:
        raise ValueError(f"all_gather: parts differ in shape or dtype: {shapes}")
    return arr


def assemble(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards of an output sharded over a mesh axis, concatenated on the
    mesh's first device: what the JAX package returns as one sharded array.
    Not a collective of the program, so not recorded."""
    return torch.cat([p.to(mesh.first) for p in parts], 0)
