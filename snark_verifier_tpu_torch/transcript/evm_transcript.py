"""The EVM (keccak256) Fiat–Shamir transcript: the counterpart of the JAX
package's `transcript/evm_transcript.py` (`EvmTranscriptPy` :30,
`EvmTranscript` :90), after the reference's transcript/evm.rs:163-244.

  * common_scalar absorbs the scalar as 32 big-endian bytes;
  * common_ec_point absorbs x ‖ y, each 32 big-endian bytes of the Fq
    coordinate as it is (not mod r); the identity is invalid;
  * squeeze_challenge hashes the buffer (with 0x01 after it when the buffer
    is one 32-byte word, evm.rs:88); the buffer becomes the hash, and the
    challenge is the hash read big-endian, mod r.

`EvmTranscript` walks a batch's pre-parsed streams on one device, as
`PoseidonTranscript` does: scalars (B, n, 8) Fr words, points (B, m, 2, 8)
affine Fq words, both Montgomery form.  It buffers (handle, tag) pairs,
handles of shape (B, 8) or (8,) (a constant such as the protocol's initial
state, broadcast to the batch), and each squeeze is one
`hash/keccak_device.py::squeeze`: on the card one launch of
`svt_keccak_read` with a schedule of one squeeze, which leaves each tagged
word's Montgomery form itself.  After a
squeeze the buffer holds the raw hash alone (tag TAG_RAW), not the
challenge.  `EvmTranscriptPy` is the python-int oracle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import errors
from ..ff import FRW
from ..ff.spec import FQ, FR
from ..hash.keccak import keccak256
from ..hash.keccak_device import TAG_FQ, TAG_FR, TAG_RAW, squeeze


class EvmTranscript:
    """Reading keccak transcript over a batch's stacked proof streams."""

    def __init__(self, scalars, points, device=None):
        """`device` is the streams' own; it is taken for the interface
        `PoseidonTranscript` shares."""
        self._scalars = scalars
        self._points = points
        self.batch = scalars.shape[0]
        self._buf: List = []  # (handle, tag)
        self._si = 0
        self._pi = 0

    def common_scalar(self, s):
        self._buf.append((s, TAG_FR))

    def common_ec_point(self, xy):
        """xy: (B, 2, 8) affine point, Fq Montgomery words."""
        self._buf += [(xy[:, 0], TAG_FQ), (xy[:, 1], TAG_FQ)]

    def squeeze_challenge(self):
        words = torch.stack([h.expand(self.batch, 8) for h, _ in self._buf], 1).contiguous()
        h, c = squeeze(words, [t for _, t in self._buf])
        self._buf = [(h, TAG_RAW)]
        return c

    def read_scalar(self):
        s = self._scalars[:, self._si]
        self._si += 1
        self.common_scalar(s)
        return s

    def read_n_scalars(self, n: int) -> List:
        return [self.read_scalar() for _ in range(n)]

    def read_ec_point(self):
        pt = self._points[:, self._pi]
        self._pi += 1
        self.common_ec_point(pt)
        return pt

    def read_n_ec_points(self, n: int) -> List:
        return [self.read_ec_point() for _ in range(n)]


class PrecomputedChallengeTranscript:
    """A reading transcript over a batch's stacked streams (scalars (B, n,
    8), points (B, m, 2, 8), Montgomery words) that hands out a given
    challenge sequence, one entry per squeeze, and absorbs nothing.  An
    entry is a (B, 8) or (8,) tensor of Fr Montgomery words, an int, or a
    list of B ints (one a proof)."""

    def __init__(self, scalars, points, challenges: Sequence):
        self._scalars = scalars
        self._points = points
        self._challenges = list(challenges)
        self.batch = scalars.shape[0]
        self._ci = 0
        self._si = 0
        self._pi = 0

    def common_scalar(self, s):
        pass  # the challenges were hashed before

    def common_ec_point(self, xy):
        pass

    def common_lane_point(self, k: int):
        pass  # an instance commitment, hashed with the rest before

    def squeeze_challenge(self):
        c = self._challenges[self._ci]
        self._ci += 1
        if isinstance(c, torch.Tensor):
            return c
        dev = self._scalars.device
        if isinstance(c, (list, tuple)):
            return FRW.from_int(list(c), dev)
        return FRW.from_int(c, dev).expand(self.batch, 8)

    def read_scalar(self):
        s = self._scalars[:, self._si]
        self._si += 1
        return s

    def read_n_scalars(self, n: int) -> List:
        return [self.read_scalar() for _ in range(n)]

    def read_ec_point(self):
        pt = self._points[:, self._pi]
        self._pi += 1
        return pt

    def read_n_ec_points(self, n: int) -> List:
        return [self.read_ec_point() for _ in range(n)]


class EvmTranscriptPy:
    """Python-int oracle transcript: scalars are ints mod r, points affine
    (x, y) int tuples."""

    def __init__(self, scalars: Optional[Sequence[int]] = None, points=None):
        self.buf = b""
        self.r = FR.p
        self._scalars = list(scalars or [])
        self._points = list(points or [])
        self._si = 0
        self._pi = 0
        self.challenges: List[int] = []  # every squeezed value, in order

    def common_scalar(self, s: int):
        self.buf += (s % self.r).to_bytes(32, "big")

    def common_ec_point(self, pt):
        if pt is None:
            raise errors.TranscriptError("the identity point is invalid in the transcript")
        x, y = pt
        self.buf += (x % FQ.p).to_bytes(32, "big") + (y % FQ.p).to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        data = self.buf + (b"\x01" if len(self.buf) == 0x20 else b"")
        h = keccak256(data)
        self.buf = h
        c = int.from_bytes(h, "big") % self.r
        self.challenges.append(c)
        return c

    def read_scalar(self) -> int:
        s = self._scalars[self._si]
        self._si += 1
        self.common_scalar(s)
        return s

    def read_ec_point(self):
        pt = self._points[self._pi]
        self._pi += 1
        self.common_ec_point(pt)
        return pt

    def read_n_scalars(self, n: int) -> List[int]:
        return [self.read_scalar() for _ in range(n)]

    def read_n_ec_points(self, n: int) -> List:
        return [self.read_ec_point() for _ in range(n)]

    # the prover's side: absorb and record the stream
    def write_scalar(self, s: int):
        self.common_scalar(s)
        self._scalars.append(s % self.r)

    def write_ec_point(self, pt):
        self.common_ec_point(pt)
        self._points.append(pt)

    def streams(self):
        return list(self._scalars), list(self._points)
