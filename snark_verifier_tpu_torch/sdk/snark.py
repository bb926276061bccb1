"""The Snark container: the counterpart of the JAX package's `sdk/snark.py`
(`Snark.to_json`, `save`, `load`, `validate`, `host_streams`,
`proof_shape` :149, `gen_dummy_snark` :163).  The JSON that `to_json` and
`save` write is the JAX package's, key for key.

A proof is kept as its pre-parsed transcript streams: Fr scalars and affine
G1 points, python ints in transcript order.  `host_streams` turns them into
one numpy block each in the port's word layout, so stacking a batch is one
upload per stream.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .. import errors
from ..ec import py_ec
from ..ec.g1 import from_affine_int_np
from ..ff import np_limbs_to_words
from ..ff.spec import FQ, FR, int_to_limbs
from ..pcs.kzg.accumulator import accumulator_from_limbs_int
from ..verifier.plonk.protocol import PlonkProtocol


@dataclass
class Snark:
    protocol: PlonkProtocol
    instances: List[List[int]]
    scalars: List[int]  # proof scalar stream (transcript order)
    points: List[Tuple[int, int]]  # proof point stream (affine)

    def to_json(self) -> dict:
        return {
            "protocol": self.protocol.to_json(),
            "instances": [[hex(v) for v in col] for col in self.instances],
            "scalars": [hex(s) for s in self.scalars],
            "points": [[hex(x), hex(y)] for x, y in self.points],
        }

    @staticmethod
    def from_json(d: dict) -> "Snark":
        toint = lambda v: int(v, 16)
        return Snark(
            protocol=PlonkProtocol.from_json(d["protocol"]),
            instances=[[toint(v) for v in col] for col in d["instances"]],
            scalars=[toint(s) for s in d["scalars"]],
            points=[(toint(x), toint(y)) for x, y in d["points"]],
        )

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @staticmethod
    def load(path: str) -> "Snark":
        with open(path) as f:
            return Snark.from_json(json.load(f))

    def validate(self):
        """Reject malformed proofs before any kernel sees them: every proof
        point on the curve with reduced coordinates (the identity is
        invalid: the transcript absorbs affine coordinates), every scalar
        and instance a reduced Fr element, instance columns of the
        protocol's sizes, and every instance-encoded old accumulator
        decoding to two curve points.  Raises errors.TranscriptError /
        errors.InvalidInstances."""
        for i, pt in enumerate(self.points):
            if pt is None:
                raise errors.TranscriptError(f"proof point {i} is the identity")
            x, y = pt
            if not (0 <= x < FQ.p and 0 <= y < FQ.p):
                raise errors.TranscriptError(f"proof point {i} coordinate not reduced")
            if not py_ec.is_on_curve((x, y)):
                raise errors.TranscriptError(f"proof point {i} not on curve")
        for i, s in enumerate(self.scalars):
            if not 0 <= s < FR.p:
                raise errors.TranscriptError(f"proof scalar {i} not reduced")
        if [len(c) for c in self.instances] != self.protocol.num_instance:
            raise errors.InvalidInstances(
                f"{[len(c) for c in self.instances]} != {self.protocol.num_instance}"
            )
        for col in self.instances:
            for v in col:
                if not 0 <= v < FR.p:
                    raise errors.InvalidInstances("instance value not reduced")
        for acc_idx in self.protocol.accumulator_indices:
            lhs, rhs = accumulator_from_limbs_int([self.instances[i][j] for i, j in acc_idx])
            for name, pt in (("lhs", lhs), ("rhs", rhs)):
                if not py_ec.is_on_curve(pt):
                    raise errors.InvalidInstances(f"old accumulator {name} decodes off-curve")
        return self

    def host_streams(self):
        """-> (scalars (n, 8), points (m, 2, 8)) int32 numpy Montgomery
        words, validated first.  Memoized: a batch tiles a few fixture
        snarks, and each is converted once."""
        cached = getattr(self, "_host_streams", None)
        if cached is not None:
            return cached
        self.validate()
        p, R = FR.p, 1 << 256
        sc = (
            np_limbs_to_words(np.stack([int_to_limbs(s * R % p) for s in self.scalars]))
            if self.scalars
            else np.zeros((0, 8), np.int32)
        )
        pts = (
            np.ascontiguousarray(from_affine_int_np(self.points)[:, :2])
            if self.points
            else np.zeros((0, 2, 8), np.int32)
        )
        self._host_streams = (sc, pts)
        return sc, pts


def proof_shape(protocol: PlonkProtocol, scheme_name: str) -> Tuple[int, int]:
    """(num_scalars, num_points) of a proof stream for this protocol and
    scheme: the witness and quotient points, then the PCS proof's (GWC19 one
    a query set, SHPLONK W and W'), and one scalar per evaluation."""
    from ..pcs.kzg.multiopen import gwc_query_sets
    from ..verifier.plonk.verifier import PlonkProof

    n_points = sum(protocol.num_witness) + protocol.quotient.num_chunk()
    n_scalars = len(protocol.evaluations)
    if scheme_name == "gwc":
        n_points += len(gwc_query_sets(PlonkProof.empty_queries(protocol)))
    else:
        n_points += 2
    return n_scalars, n_points


def gen_dummy_snark(protocol: PlonkProtocol, scheme_name: str = "shplonk",
                    seed: int = 0) -> Snark:
    """A snark of the right shape for `protocol` and the scheme, its
    instances, scalars and points random (from `random.Random(seed)` and
    `py_ec.rand_points(..., seed + 1)`, as the JAX package's): it walks the
    transcript as a real proof does, and does not verify."""
    rng = random.Random(seed)
    n_scalars, n_points = proof_shape(protocol, scheme_name)
    pts = py_ec.rand_points(n_points, seed=seed + 1)
    return Snark(
        protocol=protocol,
        instances=[[rng.randrange(FR.p) for _ in range(n)] for n in protocol.num_instance],
        scalars=[rng.randrange(FR.p) for _ in range(n_scalars)],
        points=pts,
    )
