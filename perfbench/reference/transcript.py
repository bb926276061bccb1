"""The two transcripts in python ints, frozen copies of the port's
`PoseidonTranscriptPy` and `EvmTranscriptPy`: scalars are ints mod r,
points affine (x, y) int tuples, read from a proof's pre-parsed streams."""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import errors
from .fields import FQ, FR
from .keccak import keccak256
from .poseidon import PoseidonPy


class _Reader:
    def __init__(self, scalars: Optional[Sequence[int]] = None, points=None):
        self.r = FR.p
        self._scalars = list(scalars or [])
        self._points = list(points or [])
        self._si = 0
        self._pi = 0

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


class PoseidonTranscriptPy(_Reader):
    def __init__(self, scalars=None, points=None):
        super().__init__(scalars, points)
        self.h = PoseidonPy()

    def common_scalar(self, s: int):
        self.h.update([s % self.r])

    def common_ec_point(self, pt):
        if pt is None:
            raise errors.TranscriptError("the identity point is invalid in the transcript")
        x, y = pt
        self.h.update([x % self.r, y % self.r])

    def squeeze_challenge(self) -> int:
        return self.h.squeeze()


class EvmTranscriptPy(_Reader):
    def __init__(self, scalars=None, points=None):
        super().__init__(scalars, points)
        self.buf = b""

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
        return int.from_bytes(h, "big") % self.r


TRANSCRIPTS = {"poseidon": PoseidonTranscriptPy, "evm": EvmTranscriptPy}
