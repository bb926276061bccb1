"""Prime-field limb arithmetic in plain PyTorch: the counterpart of the JAX
package's `ff/jnp_field.py::LimbField`.

An element is an int64 tensor of shape (..., 16): 16 little-endian 16-bit
limbs of the Montgomery form x·R mod p, R = 2^256 (the JAX package's layout).
Limbs sit in int64 because CPU torch has no add or shift for uint32; every
16x16-bit product and every column sum below stays far inside int64.

The lazy contract is the JAX package's (`jnp_field.py:8-14`): limbs < 2^16
and the VALUE in [0, 2p].  The Montgomery product maps [0,2p]x[0,2p] into
[0,2p] with no final subtraction (4p < R), add and sub reduce mod 2p.  Every
op is the same function of its inputs as its JAX twin, so the two agree bit
for bit even before `canon`; comparisons and exports canonicalize first.

This module is the plain version that the CUDA kernels (csrc/fq.cuh) are held
against; it runs on whatever device its tensors lie on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import device_key
from .spec import MASK, NLIMBS, W, FieldSpec, int_to_limbs, limbs_to_int

_I64 = torch.int64


def _normalize(t):
    """Propagate carries (or borrows) across the last axis of signed int64
    limb columns.  Returns (limbs in [0, 2^16), carry out of the top limb).
    Loops until no limb carries: random data settles in one or two passes."""
    t = t.clone()
    out = torch.zeros(t.shape[:-1], dtype=_I64, device=t.device)
    while True:
        c = t >> W  # arithmetic shift: borrows come out as -1
        if not bool(c.any()):
            return t, out
        t &= MASK
        t[..., 1:] += c[..., :-1]
        out += c[..., -1]


class LimbField:
    """Field ops over (..., 16) int64 Montgomery-form limb tensors."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self._np = {
            "P": spec.p_limbs.astype(np.int64),
            "P2": int_to_limbs(2 * spec.p).astype(np.int64),
            "ONE": spec.r_limbs.astype(np.int64),
        }
        self.NINV = spec.ninv
        self._dev: dict = {}

    def const(self, name: str, device):
        """A (16,) constant (P, P2 or ONE, the Montgomery 1) on `device`."""
        key = (name, device_key(device))
        v = self._dev.get(key)
        if v is None:
            v = torch.as_tensor(self._np[name], device=device)
            self._dev[key] = v
        return v

    # ---------------------------------------------------------------- helpers

    def _cond_sub(self, a, m):
        """a - m if a >= m, else a (m a (16,) limb constant)."""
        d, borrow = _normalize(a - m)
        return torch.where((borrow >= 0)[..., None], d, a)

    def canon(self, a):
        """Map the redundant [0, 2p] representation to canonical [0, p)."""
        P2, P = self.const("P2", a.device), self.const("P", a.device)
        return self._cond_sub(self._cond_sub(a, P2), P)

    # ------------------------------------------------------------ arithmetic

    def add(self, a, b):
        s, _ = _normalize(a + b)  # a + b <= 4p < 2^256: no carry out
        return self._cond_sub(s, self.const("P2", s.device))

    def sub(self, a, b):
        """a - b, plus 2p when it borrows: stays in [0, 2p]."""
        d, borrow = _normalize(a - b)
        dp, _ = _normalize(d + self.const("P2", d.device))  # drops 2^256
        return torch.where((borrow < 0)[..., None], dp, d)

    def neg(self, a):
        d, _ = _normalize(self.const("P2", a.device) - a)
        return d  # 2p - a, in [0, 2p]

    def double(self, a):
        return self.add(a, a)

    def mul_small(self, a, k: int):
        """a * k for small static k via the same double/add chain as JAX."""
        if k == 0:
            return torch.zeros_like(a)
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    def mul(self, a, b):
        """Montgomery product a·b·R^-1; [0,2p] in, [0,2p] out.

        CIOS over 16-bit digits with unnormalized int64 columns: step i adds
        a_i·b at column i, then the reduction digit m_i, then pushes column
        i's high bits up.  m = Σ m_i 2^(16i) is the unique m < R with
        a·b + m·p ≡ 0 mod R, so the result (a·b + m·p)/R is the same number
        as the JAX package's CIOS and the CUDA kernel's 32-bit CIOS.
        Columns stay < 2^38."""
        a, b = torch.broadcast_tensors(a, b)
        P = self.const("P", a.device)
        t = a.new_zeros(*a.shape[:-1], 2 * NLIMBS)
        for i in range(NLIMBS):
            t[..., i : i + NLIMBS] += a[..., i : i + 1] * b
            m = (t[..., i] * self.NINV) & MASK
            t[..., i : i + NLIMBS] += m.unsqueeze(-1) * P
            t[..., i + 1] += t[..., i] >> W
        s, _ = _normalize(t[..., NLIMBS:])  # value < 2p < 2^256
        return s

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """a^(p-2) by square-and-multiply (0 maps to 0)."""
        acc = self.const("ONE", a.device).expand_as(a)
        e = self.spec.p - 2
        for bit in bin(e)[2:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    # ------------------------------------------------------------ predicates

    def is_zero(self, a):
        return (self.canon(a) == 0).all(-1)

    # ----------------------------------------------------------- conversions

    def from_int(self, x, device="cpu"):
        """Host: python int(s) -> Montgomery limb tensor on `device`."""
        p, R = self.spec.p, 1 << (W * NLIMBS)
        if isinstance(x, (list, tuple)):
            arr = np.stack([int_to_limbs((int(v) % p) * R % p) for v in x])
        else:
            arr = int_to_limbs((int(x) % p) * R % p)
        return torch.as_tensor(arr.astype(np.int64), device=device)

    def to_int(self, a):
        """Host: Montgomery limb tensor -> python int(s) (canonical)."""
        p, R = self.spec.p, 1 << (W * NLIMBS)
        rinv = pow(R, -1, p)
        mont = a.detach().cpu().numpy()
        if mont.ndim == 1:
            return limbs_to_int(mont) * rinv % p
        flat = mont.reshape(-1, NLIMBS)
        vals = [limbs_to_int(v) * rinv % p for v in flat]
        return np.array(vals, dtype=object).reshape(mont.shape[:-1])


@functools.lru_cache(maxsize=None)
def get_field(spec: FieldSpec) -> LimbField:
    return LimbField(spec)
