"""A proof as the fixtures store it, read from its JSON without the
program: the protocol, the instances, and the proof's pre-parsed transcript
streams (Fr scalars and affine G1 points, python ints in transcript
order)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Tuple

from .protocol import PlonkProtocol


@dataclass
class Snark:
    protocol: PlonkProtocol
    instances: List[List[int]]
    scalars: List[int]
    points: List[Tuple[int, int]]

    @staticmethod
    def from_json(d: dict) -> "Snark":
        toint = lambda v: int(v, 16)
        return Snark(
            protocol=PlonkProtocol.from_json(d["protocol"]),
            instances=[[toint(v) for v in col] for col in d["instances"]],
            scalars=[toint(s) for s in d["scalars"]],
            points=[(toint(x), toint(y)) for x, y in d["points"]],
        )

    @staticmethod
    def load(path) -> "Snark":
        with open(path) as f:
            return Snark.from_json(json.load(f))
