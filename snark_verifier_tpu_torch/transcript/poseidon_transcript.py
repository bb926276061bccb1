"""The Poseidon Fiat–Shamir transcript: the counterpart of the JAX package's
`transcript/poseidon_transcript.py` (`fq_to_fr` :31, `PoseidonTranscript`
:37, `PoseidonTranscriptPy` :97).

  * common_scalar absorbs the Fr scalar;
  * common_ec_point absorbs (x mod r, y mod r) of the affine point; the
    identity is invalid;
  * squeeze_challenge is the Poseidon sponge's squeeze (T = 3, RATE = 2,
    R_F = 8, R_P = 57).

`PoseidonTranscript` walks a batch's pre-parsed streams on one device:
scalars (B, n, 8) Fr words, points (B, m, 2, 8) affine Fq words, both
Montgomery form.  Stream points were checked on the host
(`Snark.validate`), so none is the identity.  Their coordinates are mapped
Fq -> Fr once for the whole stream (one `svt_points_to_fr` launch per batch
on the card), and each read absorbs its slice.  `absorb_ec_points` takes a
whole stack of affine points at once, `absorb_projective_points` a stack of
projective ones (the accumulation fold's M accumulator points: the affine
normalisation and the map in one `svt_points_to_fr` launch); the next
squeeze absorbs all 2M coordinates in one `svt_poseidon_absorb` launch, the
same sponge as M `common_ec_point` calls.  `PoseidonTranscriptPy` is the
python-int oracle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .. import errors
from ..ff import points_to_fr
from ..ff.spec import FR
from ..hash.poseidon import PoseidonPy, PoseidonSponge


def fq_to_fr(x_fq_mont):
    """The canonical-value map Fq -> Fr (x mod r) on Montgomery words.

    q < 2r, so a canonical Fq value already is an Fr value in the lazy
    [0, 2r] contract, and the map is one to-Montgomery multiply (the Fr
    multiply takes inputs up to 2r): one `svt_points_to_fr` launch on the
    card."""
    return points_to_fr(x_fq_mont)


class PoseidonTranscript:
    """Reading transcript over a batch's stacked proof streams."""

    def __init__(self, scalars, points, device):
        self.h = PoseidonSponge(scalars.shape[0], device)
        self._scalars = scalars
        self._points = points
        self._points_fr = fq_to_fr(points)  # (B, m, 2, 8): what the sponge absorbs
        self._si = 0
        self._pi = 0

    def common_scalar(self, s):
        self.h.update([s])

    def common_ec_point(self, xy):
        """xy: (B, 2, 8) affine point, Fq Montgomery words."""
        self._absorb_fr(fq_to_fr(xy))

    def absorb_ec_points(self, xy):
        """xy: (B, M, 2, 8) affine points, Fq Montgomery words -> their 2M
        coordinates buffered in order (x₀, y₀, x₁, y₁, …).  The identity's
        affine form (0, 0) is absorbed as it is, as the JAX package's device
        transcript does (`absorb_ec_points_scanned`)."""
        fr = fq_to_fr(xy)
        self.h.update_block(fr.reshape(fr.shape[0], -1, 8))

    def absorb_projective_points(self, pts):
        """pts: (B, M, 3, 8) projective points, Fq Montgomery words -> the
        2M coordinates of their affine forms buffered as `absorb_ec_points`
        buffers them, normalised and mapped Fq -> Fr in one
        `points_to_fr(pts, projective=True)`; the identity is absorbed as
        (0, 0), as the JAX package's `G1.to_affine` +
        `absorb_ec_points_scanned`."""
        fr = points_to_fr(pts, projective=True)
        self.h.update_block(fr.reshape(fr.shape[0], -1, 8))

    def _absorb_fr(self, fr):
        self.h.update([fr[:, 0], fr[:, 1]])

    def squeeze_challenge(self):
        return self.h.squeeze()

    def read_scalar(self):
        s = self._scalars[:, self._si]
        self._si += 1
        self.common_scalar(s)
        return s

    def read_n_scalars(self, n: int) -> List:
        return [self.read_scalar() for _ in range(n)]

    def read_ec_point(self):
        pt = self._points[:, self._pi]
        self._absorb_fr(self._points_fr[:, self._pi])
        self._pi += 1
        return pt

    def read_n_ec_points(self, n: int) -> List:
        return [self.read_ec_point() for _ in range(n)]


class PoseidonTranscriptPy:
    """Python-int oracle transcript: scalars are ints mod r, points affine
    (x, y) int tuples."""

    def __init__(self, scalars: Optional[Sequence[int]] = None,
                 points: Optional[Sequence] = None):
        self.r = FR.p
        self.h = PoseidonPy()
        self._scalars = list(scalars or [])
        self._points = list(points or [])
        self._si = 0
        self._pi = 0

    def common_scalar(self, s: int):
        self.h.update([s % self.r])

    def common_ec_point(self, pt):
        if pt is None:
            raise errors.TranscriptError("the identity point is invalid in the transcript")
        x, y = pt
        self.h.update([x % self.r, y % self.r])

    def squeeze_challenge(self) -> int:
        return self.h.squeeze()

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
    def write_ec_point(self, pt):
        self.common_ec_point(pt)
        self._points.append(pt)

    def streams(self):
        return list(self._scalars), list(self._points)
