"""The KZG structured reference string: the counterpart of the JAX
package's `sdk/srs.py` (`Srs`, `load_params`, G2 decoding).

The succinct verifier needs the generator g = [τ⁰]G1 (the reference's
KzgSuccinctVerifyingKey); the decide needs the Miller-loop lines of
(g2, −s_g2) (the KzgDecidingKey), prepared once on the host and kept per
device as words (`decider_coeffs`).  The host provers commit through
`Srs.commit`: one MSM on the card over the SRS's own bases, uploaded once
per device.  `toy_srs` makes the deterministic toy setup with a known
trapdoor that tests and the pairing benchmark use; `lagrange_commitments`
derives its Lagrange basis from the trapdoor, and `save_params` writes it
all back.  The file is halo2's `ParamsKZG` in the "Processed" layout:
    k: u32 LE
    g:          2^k G1 points, 32 B compressed each
    g_lagrange: 2^k G1 points, 32 B compressed each
    g2, s_g2:   64 B compressed G2 each (x = c0 ‖ c1 LE, the parity of y's
                c0 in bit 7 of byte 63; infinity all zeros)
"""

from __future__ import annotations

import functools
import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import errors
from ..device import device_key
from ..ec import py_ec
from ..ec.g1 import from_affine_int_np
from ..ff.spec import FQ, FR
from ..msm.pippenger import msm_int
from ..pairing import py_pairing as pp
from ..pairing.pairing import coeffs_to_device, prepare_g2_coeffs
from . import aot
from .proof_io import g1_from_bytes, g1_to_bytes


@dataclass
class Srs:
    """KZG SRS over BN254: host ints, plus the generator's words per device."""

    g1_powers: List  # [τ^i]·G1 affine int tuples, i = 0..n-1
    g2: Tuple  # G2 affine (Fq2 int pair tuple)
    s_g2: Tuple  # [τ]·G2
    g_lagrange: List = field(default_factory=list)
    tau: Optional[int] = field(default=None, repr=False)  # toy_srs's trapdoor
    _g_words: Dict = field(default_factory=dict, repr=False, compare=False)
    _decider: Dict = field(default_factory=dict, repr=False, compare=False)
    _g_limbs: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def g(self):
        return self.g1_powers[0]

    def commit(self, coeffs: Sequence[int], device=None):
        """Σ cᵢ·[τ^i]G1 -> an affine tuple of python ints (None for the
        identity): the host provers' commitment.  device None means the
        CUDA card: one `msm_checked` over the first len(coeffs) powers,
        their (n, 3, 16) limbs uploaded once per device; "cpu" runs
        `py_ec.msm` (`msm.pippenger.msm_int`)."""
        if len(coeffs) > len(self.g1_powers):
            raise ValueError(f"commit: {len(coeffs)} coefficients for an SRS of "
                             f"{len(self.g1_powers)}")
        return msm_int(self.g1_powers, self._g_limbs, coeffs, device)

    def lagrange_commitments(self) -> List:
        """The Lagrange-basis commitments [L_i(τ)]G1, i < n: `g_lagrange`
        as `load_params` read it, or, when that list is empty, derived from
        the toy trapdoor, L_i(τ) = ω^i (τ^n − 1) / (n (τ − ω^i)), and kept
        in `g_lagrange` (the JAX package's `Srs.g_lagrange()`; here
        `g_lagrange` stays the field that `load_params` fills)."""
        if self.g_lagrange:
            return self.g_lagrange
        if self.tau is None:
            raise ValueError("Lagrange commitments need the trapdoor or the file's data")
        from ..verifier.plonk.protocol import Domain

        n, tau = len(self.g1_powers), self.tau
        d = Domain.bn254(n.bit_length() - 1)
        znm1 = (pow(tau, n, FR.p) - 1) % FR.p
        for i in range(n):
            w = d.rotate(i)
            li = w * znm1 % FR.p * pow(n * (tau - w) % FR.p, -1, FR.p) % FR.p
            self.g_lagrange.append(py_ec.scalar_mul(py_ec.G1_GEN, li))
        return self.g_lagrange

    def content_hash(self) -> str:
        """A stable digest of what the verifier takes from the SRS (g, g2,
        s_g2): the JAX package's `Srs.content_hash`, the same value."""
        return hashlib.sha256(repr((self.g, self.g2, self.s_g2)).encode()).hexdigest()

    def g_dev(self, device):
        """g as (3, 8) projective Montgomery words on `device`, cached."""
        key = device_key(device)
        if key not in self._g_words:
            self._g_words[key] = torch.from_numpy(from_affine_int_np([self.g])[0]).to(device)
        return self._g_words[key]

    @functools.cached_property
    def decider_coeffs_host(self):
        """The Miller-loop lines of (g2, −s_g2) as numpy words (dbl, addc,
        has_add, finals): python-int G2 arithmetic, once per Srs."""
        return prepare_g2_coeffs([self.g2, pp.g2_neg(self.s_g2)])

    def decider_coeffs(self, device):
        """`decider_coeffs_host` on `device`, uploaded once per device.  Where
        the warm-start cache is on for `device` (`sdk/aot.py`), the host
        lines come from it, or are computed and saved to it."""
        key = device_key(device)
        if key not in self._decider:
            if aot.enabled(device) and "decider_coeffs_host" not in self.__dict__:
                self.__dict__["decider_coeffs_host"] = aot.load_or_compile(
                    ("g2_lines", self.content_hash()), lambda: self.decider_coeffs_host,
                    _lines_record, _lines_from)
            self._decider[key] = coeffs_to_device(self.decider_coeffs_host, device)
        return self._decider[key]


def _lines_record(coeffs):
    dbl, addc, has_add, finals = coeffs
    return {"dbl": dbl, "addc": addc, "has_add": np.asarray(has_add, np.bool_),
            "finals": finals}, {}


def _lines_from(arrays, meta):
    return arrays["dbl"], arrays["addc"], arrays["has_add"], arrays["finals"]


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


def _g2_to_bytes(pt) -> bytes:
    """A G2 point's 64-byte compressed form: x = c0 ‖ c1 little-endian, the
    parity of y's c0 in bit 7 of byte 63; the identity all zeros."""
    if pt is None:
        return bytes(64)
    (x0, x1), (y0, _) = pt
    b = bytearray(int(x0).to_bytes(32, "little") + int(x1).to_bytes(32, "little"))
    b[63] |= (y0 & 1) << 7
    return bytes(b)


def save_params(srs: Srs, path: str):
    """Write `srs` in the 'Processed' ParamsKZG layout (the JAX package's
    `save_params`, byte for byte); its Lagrange part is
    `srs.lagrange_commitments()`."""
    n = len(srs.g1_powers)
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError("SRS size must be a power of two")
    lag = srs.lagrange_commitments()
    with open(path, "wb") as f:
        f.write(int(k).to_bytes(4, "little"))
        for pt in list(srs.g1_powers) + list(lag):
            f.write(g1_to_bytes(pt))
        f.write(_g2_to_bytes(srs.g2))
        f.write(_g2_to_bytes(srs.s_g2))


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


@functools.lru_cache(maxsize=None)
def toy_srs(n: int, seed: int = 0xA11CE) -> Srs:
    """Deterministic toy SRS with a known trapdoor τ (tests and benchmarks
    only): [τ^i]G1 for i < n, G2's generator and [τ]G2; the JAX package's
    `toy_srs`, in python ints."""
    tau = random.Random(seed).randrange(1, FR.p)
    g1_powers = [py_ec.scalar_mul(py_ec.G1_GEN, pow(tau, i, FR.p)) for i in range(n)]
    return Srs(g1_powers=g1_powers, g2=pp.G2_GEN, s_g2=pp.g2_scalar_mul(pp.G2_GEN, tau), tau=tau)
