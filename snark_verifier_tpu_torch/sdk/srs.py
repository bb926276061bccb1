"""The KZG structured reference string: the counterpart of the JAX
package's `sdk/srs.py` (`Srs`, `load_params`, G2 decoding).

The succinct verifier needs only the generator g = [τ⁰]G1 (the reference's
KzgSuccinctVerifyingKey); g2 and s_g2 are decoded and kept for the pairing
decide.  The file is halo2's `ParamsKZG` in the "Processed" layout:
    k: u32 LE
    g:          2^k G1 points, 32 B compressed each
    g_lagrange: 2^k G1 points, 32 B compressed each
    g2, s_g2:   64 B compressed G2 each (x = c0 ‖ c1 LE, the parity of y's
                c0 in bit 7 of byte 63; infinity all zeros)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from .. import errors
from ..ec.g1 import from_affine_int_np
from ..ff.spec import FQ, FR
from ..pairing import py_pairing as pp
from .proof_io import g1_from_bytes


@dataclass
class Srs:
    """KZG SRS over BN254: host ints, plus the generator's words per device."""

    g1_powers: List  # [τ^i]·G1 affine int tuples, i = 0..n-1
    g2: Tuple  # G2 affine (Fq2 int pair tuple)
    s_g2: Tuple  # [τ]·G2
    g_lagrange: List = field(default_factory=list)
    _g_words: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def g(self):
        return self.g1_powers[0]

    def g_dev(self, device):
        """g as (3, 8) projective Montgomery words on `device`, cached."""
        key = str(device)
        if key not in self._g_words:
            self._g_words[key] = torch.from_numpy(from_affine_int_np([self.g])[0]).to(device)
        return self._g_words[key]


def g2_from_bytes(b: bytes):
    """Decompress a G2 point (on the twist y² = x³ + 3/ξ)."""
    q = FQ.p
    raw = bytearray(b)
    ysign = raw[63] >> 7
    raw[63] &= 0x7F
    x0 = int.from_bytes(raw[:32], "little")
    x1 = int.from_bytes(raw[32:64], "little")
    if x0 >= q or x1 >= q:
        raise errors.TranscriptError("invalid G2 x encoding")
    if x0 == 0 and x1 == 0 and not ysign:
        return None
    x = (x0, x1)
    y = pp.f2_sqrt(pp.f2_add(pp.f2_mul(pp.f2_sq(x), x), pp.B2))
    if y is None:
        raise errors.TranscriptError("G2 point not on curve (no sqrt)")
    if (y[0] & 1) != ysign:
        y = pp.f2_neg(y)
    return (x, y)


def load_params(path: str) -> Srs:
    """Read a 'Processed'-layout ParamsKZG file, decompressing (and so
    checking) every point."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 4:
        raise errors.TranscriptError("SRS file truncated (no header)")
    k = int.from_bytes(data[:4], "little")
    if k > FR.two_adicity:
        raise errors.TranscriptError(f"SRS k={k} exceeds field two-adicity")
    n = 1 << k
    expected = 4 + 2 * n * 32 + 128
    if len(data) != expected:
        raise errors.TranscriptError(f"SRS file size {len(data)} != {expected} for k={k}")
    pts = [g1_from_bytes(data[4 + 32 * i : 4 + 32 * (i + 1)]) for i in range(2 * n)]
    pos = 4 + 2 * n * 32
    return Srs(
        g1_powers=pts[:n],
        g2=g2_from_bytes(data[pos : pos + 64]),
        s_g2=g2_from_bytes(data[pos + 64 : pos + 128]),
        g_lagrange=pts[n:],
    )
