"""Field arithmetic on the kernels' word layout, Fq and Fr: the layout the
verifier's handles keep on every device.

An element is an int32 tensor of shape (..., 8) whose bits are 8
little-endian 32-bit words of the Montgomery form x·R mod p (R = 2^256):
the same numbers as the JAX package's (..., 16) 16-bit limbs, repacked
(`limbs_to_words`, `words_to_limbs`).  The lazy [0, 2p] contract is the JAX
package's and ff/limb_field.py's.

`WordField` holds the primitive ops — mul, add, sub, neg, inv, canon — as
wrappers of the CUDA kernels in csrc/field_kernels.cu: on a CUDA tensor each
op is one kernel launch (never a host synchronisation); only on a CPU tensor
does it run the plain twin, the same op of `LimbField` on the repacked
limbs.  On top of them sit the composite ops the JAX package's
`ff/jnp_field.py::LimbField` offers (pow_static :200, batch_inv :236,
to_mont / from_mont :273-279) and the 4-bit digit split of canonical words
(`u16_limbs_to_digits4` :314).

| wrapper  | CUDA kernel       | replaces (XLA, JAX package)            |
| -------- | ----------------- | -------------------------------------- |
| `mul`    | `svt_field_mul`   | `ff/jnp_field.py::LimbField.mul` :145  |
| `add`    | `svt_field_add`   | `LimbField.add` :127                   |
| `sub`    | `svt_field_sub`   | `LimbField.sub` :132                   |
| `neg`    | `svt_field_neg`   | `LimbField.neg` :141                   |
| `inv`    | `svt_field_inv`   | `LimbField.inv` :211                   |
| `canon`  | `svt_field_canon` | `LimbField.canon` :121                 |

`points_to_fr` is the one field launch the Poseidon paths make: the
transcript's canonical-value map Fq -> Fr (the JAX package's
`transcript/poseidon_transcript.py::fq_to_fr` :31), and in projective mode
the affine normalisation before it (`ec/curve.py::to_affine` :261), as one
launch of `svt_points_to_fr`; `points_to_fr_plain` runs the same primitive
ops one by one.  With `map_fr=False` it is the normalisation alone
(canonical affine Fq words: the keccak read's instance commitments).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._build import load_library
from .._launch import launch, same_device
from .limb_field import get_field
from .spec import FQ, FR, NLIMBS, W, FieldSpec, int_to_limbs

NWORDS = 8  # 32-bit words per element
_TAGS = {FQ.name: 0, FR.name: 1}  # the field tags of csrc/fq.cuh


# ------------------------------------------------------------------ layouts


def limbs_to_words(limbs):
    """(..., 16) 16-bit limbs (any integer dtype) -> (..., 8) int32 words."""
    l = limbs.to(torch.int64).reshape(*limbs.shape[:-1], NWORDS, 2)
    w = l[..., 0] | (l[..., 1] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_to_limbs(words):
    """(..., 8) int32 words -> (..., 16) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        *words.shape[:-1], 2 * NWORDS
    )


def np_limbs_to_words(arr) -> np.ndarray:
    """Host: numpy (..., 16) 16-bit limbs (the JAX package's uint32 arrays)
    -> numpy (..., 8) int32 words, ready for one upload."""
    a = np.asarray(arr).astype(np.uint32)
    w = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return np.ascontiguousarray(w).view(np.int32)


def from_jax_elems(arr, device=None):
    """JAX-package field elements ((..., 16) 16-bit limbs, numpy) -> (..., 8)
    int32 words on `device` (None: the CUDA card)."""
    from ..device import resolve_device

    return torch.from_numpy(np_limbs_to_words(arr)).to(resolve_device(device))


def to_jax_elems(words) -> np.ndarray:
    """(..., 8) int32 words -> (..., 16) uint32 numpy limbs, the JAX
    package's layout."""
    return words_to_limbs(words).cpu().numpy().astype(np.uint32)


def digits4(canon_words):
    """(..., 8) canonical words -> (..., 64) int64 4-bit digits, LSB first
    (digit j of word i at 8·i + j: the JAX package's u16_limbs_to_digits4
    order, limb by limb)."""
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=canon_words.device)
    d = (canon_words[..., :, None] >> shifts) & 0xF  # arithmetic shift; low 4 bits kept
    return d.reshape(*canon_words.shape[:-1], 8 * NWORDS).to(torch.int64)


# -------------------------------------------------------------------- field


class WordField:
    """Montgomery arithmetic over (..., 8) int32 word tensors of one field."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.tag = _TAGS[spec.name]
        self.limb = get_field(spec)  # the plain twin
        R = 1 << (W * NLIMBS)
        self._host = {
            "ONE": spec.r,
            "R2": spec.r2,  # to-Montgomery multiplier
            "ONE_PLAIN": 1,  # from-Montgomery multiplier (plain 1, not R)
        }
        self._R = R
        self._cache: dict = {}

    # ------------------------------------------------------------ constants

    def _words(self, raw: int, device):
        key = (raw, str(device))
        v = self._cache.get(key)
        if v is None:
            v = limbs_to_words(torch.as_tensor(int_to_limbs(raw).astype(np.int64))).to(device)
            self._cache[key] = v
        return v

    def const(self, name: str, device):
        """A (8,) word constant (ONE, R2 or ONE_PLAIN) on `device`, cached."""
        return self._words(self._host[name], device)

    def scalar(self, v: int, device):
        """The Montgomery form of python int v as a (8,) constant on `device`,
        cached per (value, device): one upload per constant per process."""
        return self._words((int(v) % self.spec.p) * self._R % self.spec.p, device)

    # --------------------------------------------------------- primitives

    @staticmethod
    def _check(name, t):
        """Any (..., 8) int32 tensor on the CPU or a card; the wrapper makes
        kernel operands contiguous and aligned itself."""
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() < 1 or t.shape[-1] != NWORDS:
            raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")

    @staticmethod
    def _operand(t, shape):
        """(tensor, stride in words) for a kernel operand of broadcast shape."""
        if t.numel() == NWORDS:
            t, stride = t.reshape(NWORDS), 0
        else:
            t, stride = (t if tuple(t.shape) == tuple(shape) else t.expand(shape)), NWORDS
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        return t, stride

    def plain(self, op: str, *args):
        """The plain twin of primitive `op` on any device: the `LimbField`
        op on the repacked limbs (what the kernels are held against)."""
        return limbs_to_words(getattr(self.limb, op)(*map(words_to_limbs, args)))

    def _binary(self, op: str, a, b):
        self._check(f"field_{op}", a)
        self._check(f"field_{op}", b)
        same_device(f"field_{op}", a, b)
        if a.device.type == "cpu":
            return self.plain(op, a, b)
        shape = torch.broadcast_shapes(a.shape, b.shape)
        n = math.prod(shape[:-1])
        a2, sa = self._operand(a, shape)
        b2, sb = self._operand(b, shape)
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
        if n:
            fn = getattr(load_library(), f"svt_field_{op}")
            launch(f"field_{op}", fn, self.tag, a2.data_ptr(), sa, b2.data_ptr(), sb,
                   out.data_ptr(), n, device=a.device)
        return out

    def _unary(self, op: str, a):
        self._check(f"field_{op}", a)
        if a.device.type == "cpu":
            return self.plain(op, a)
        a2 = a.contiguous()
        if a2.data_ptr() % 16:
            a2 = a2.clone()
        out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
        n = a.numel() // NWORDS
        if n:
            fn = getattr(load_library(), f"svt_field_{op}")
            launch(f"field_{op}", fn, self.tag, a2.data_ptr(), out.data_ptr(), n,
                   device=a.device)
        return out

    def mul(self, a, b):
        """Montgomery product a·b·R^-1; [0,2p] in, [0,2p] out."""
        return self._binary("mul", a, b)

    def add(self, a, b):
        """a + b mod 2p."""
        return self._binary("add", a, b)

    def sub(self, a, b):
        """a - b, plus 2p when it borrows: stays in [0, 2p]."""
        return self._binary("sub", a, b)

    def neg(self, a):
        """2p - a."""
        return self._unary("neg", a)

    def inv(self, a):
        """The inverse, 0 mapping to 0.  On the card `svt_field_inv`'s binary
        GCD, canonical in [0, p); on the CPU the plain Fermat a^(p-2), lazy
        in [0, 2p]: the same value."""
        return self._unary("inv", a)

    def canon(self, a):
        """The canonical representative in [0, p)."""
        return self._unary("canon", a)

    # ---------------------------------------------------------- composites

    def square(self, a):
        return self.mul(a, a)

    def one_like(self, a):
        return self.const("ONE", a.device).expand(a.shape)

    def pow_static(self, a, e: int):
        """a^e for a host int e, square-and-multiply from the top bit."""
        if e == 0:
            return self.one_like(a).contiguous()
        acc = a
        for bit in bin(e)[3:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def powers(self, x, n: int):
        """[1, x, ..., x^(n-1)], each of x's shape."""
        out = [self.one_like(x).contiguous()]
        for _ in range(n - 1):
            out.append(self.mul(out[-1], x))
        return out

    def is_zero(self, a):
        return (self.canon(a) == 0).all(-1)

    def batch_inv(self, a):
        """Montgomery-trick inversion over the leading axis (zeros map to
        zero).  The prefix products run in sequence where the JAX package
        takes a parallel prefix scan: the same values, possibly other lazy
        representatives, so results compare canonically.  Launches: k - 1
        prefix muls, one inv, k - 1 muls down the chain, one batched mul."""
        k = a.shape[0]
        is_z = self.is_zero(a)[..., None]
        a_safe = torch.where(is_z, self.const("ONE", a.device), a)
        prefix = [a_safe[0]]
        for i in range(1, k):
            prefix.append(self.mul(prefix[-1], a_safe[i]))
        carry = [self.inv(prefix[-1])]  # carry before step i, from i = k-1 down
        for i in range(k - 1, 0, -1):
            carry.append(self.mul(carry[-1], a_safe[i]))
        carries = torch.stack(carry[::-1], 0)
        prev = torch.stack([self.one_like(a_safe[0])] + prefix[:-1], 0)
        out = self.mul(carries, prev)
        return torch.where(is_z, torch.zeros_like(out), out)

    def to_mont(self, a):
        """Plain canonical words -> Montgomery form."""
        return self.mul(a, self.const("R2", a.device))

    def from_mont(self, a):
        """Montgomery form -> canonical plain words."""
        return self.canon(self.mul(a, self.const("ONE_PLAIN", a.device)))

    # --------------------------------------------------------- host codecs

    def from_int(self, x, device="cpu"):
        """Host: python int(s) -> Montgomery words on `device`."""
        return limbs_to_words(self.limb.from_int(x)).to(device)

    def to_int(self, a):
        """Host: Montgomery words -> canonical python int(s)."""
        return self.limb.to_int(words_to_limbs(a.detach().cpu()))


FQW = WordField(FQ)
FRW = WordField(FR)


# ---------------------------------------------------------- Fq -> Fr map


def points_to_fr_plain(x, projective: bool = False, map_fr: bool = True):
    """The plain version of `svt_points_to_fr` on any device: the primitive
    ops' plain twins in the kernel's order.  Affine mode: (..., 8) Fq
    Montgomery words -> (..., 8) Fr Montgomery words of the value mod r
    (from_mont, canon, then Fr's to_mont; q < 2r, so the canonical Fq
    value is a lazy Fr input).  Projective mode: (..., 3, 8) points ->
    (..., 2, 8), the map of the affine (X/Z, Y/Z); the identity (Z ≡ 0)
    maps to (0, 0).  Projective mode with `map_fr=False`: the affine
    (X/Z, Y/Z) itself, canonical Fq Montgomery words (the JAX package's
    G1.to_affine, canonical); the identity is (0, 0)."""
    _mode(projective, map_fr)
    if projective:
        zinv = FQW.plain("inv", x[..., 2, :])
        x = FQW.plain("mul", x[..., :2, :], zinv[..., None, :])
        if not map_fr:
            return FQW.plain("canon", x)
    c = FQW.plain("canon", FQW.plain("mul", x, FQW.const("ONE_PLAIN", x.device)))
    return FRW.plain("mul", c, FRW.const("R2", x.device))


def _mode(projective: bool, map_fr: bool) -> int:
    """svt_points_to_fr's mode: 0 affine, 1 projective, 2 projective to
    affine Fq."""
    if not (projective or map_fr):
        raise ValueError("points_to_fr: map_fr=False takes projective points")
    return 0 if not projective else 1 if map_fr else 2


def points_to_fr(x, projective: bool = False, map_fr: bool = True):
    """`points_to_fr_plain`'s function: on a CUDA tensor one launch of
    `svt_points_to_fr` (csrc/field_kernels.cu), on a CPU tensor the plain
    version.  The words are the same: each leaves a canonical value through
    the same Fr product (or, `map_fr=False`, through the same canon)."""
    name = "points_to_fr"
    mode = _mode(projective, map_fr)
    WordField._check(name, x)
    tail = (3, NWORDS) if projective else (NWORDS,)
    if tuple(x.shape[x.dim() - len(tail):]) != tail:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)} for "
                         f"{'projective' if projective else 'affine'} mode")
    if x.device.type == "cpu":
        return points_to_fr_plain(x, projective, map_fr)
    x2 = x.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    shape = (*x.shape[:-2], 2, NWORDS) if projective else tuple(x.shape)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    n = x.numel() // (3 * NWORDS if projective else NWORDS)
    if n:
        launch(name, load_library().svt_points_to_fr, x2.data_ptr(), mode,
               out.data_ptr(), n, device=x.device)
    return out
