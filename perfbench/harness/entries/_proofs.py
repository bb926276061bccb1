"""The proof-lane traffic on both sides: the configuration's pool of proofs
(one JSON line a proof, its protocol in a file of its own) read once, the
program's `Snark` objects built from it (tampered copies sharing the one
protocol object), and the reference's own reading of the same lines.
The reference's work runs on a few processes, each reading the protocol
and the SRS once."""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Tuple

import reference
from reference import Snark as RefSnark, ToySrs
from reference.protocol import PlonkProtocol as RefProtocol

from .. import traffic as tr
from ..catalog import BENCH_DIR


def _ints(row: dict):
    """A pool line -> (instances, scalars, points) as python ints."""
    h = lambda v: int(v, 16)
    return ([[h(v) for v in col] for col in row["instances"]], [h(s) for s in row["scalars"]],
            [(h(x), h(y)) for x, y in row["points"]])


class ProofPool:
    def __init__(self, config: dict, traffic: dict, seed: int):
        fx = config["fixtures"]
        d = BENCH_DIR / fx["dir"]
        self.protocol_path = d / fx["protocol"]
        self.srs_path = d / config["srs"]["file"]
        self.trapdoor_seed = int(config["srs"]["trapdoor_seed"], 0)
        self.scheme, self.transcript = config["scheme"], traffic["transcript"]
        with open(d / fx["pools"][self.transcript]) as f:
            self.rows = [_ints(json.loads(line)) for line in f if line.strip()]
        self.plan = tr.proof_lanes(traffic, seed, len(self.rows))

    def content(self, key):
        """The (instances, scalars, points) of a lane's key, fresh lists."""
        kind, i = key
        if kind == "fixture":
            inst, sc, pts = self.rows[i]
            return [list(c) for c in inst], list(sc), list(pts)
        v = self.plan.variants[i]
        return v.apply(*self.rows[v.fixture])

    @staticmethod
    def key(lane: Tuple[int, object]):
        f, t = lane
        return ("tamper", t) if t is not None else ("fixture", f)

    def program_batches(self, snark_cls, protocol) -> List[list]:
        """Every input as the program's Snark objects: one object a distinct
        lane content, all on the one `protocol` object."""
        made = {}
        out = []
        for batch in self.plan.batches:
            row = []
            for lane in batch:
                key = self.key(lane)
                if key not in made:
                    made[key] = snark_cls(protocol, *self.content(key))
                row.append(made[key])
            out.append(row)
        return out

    def keys(self) -> List[tuple]:
        """Every distinct lane content the inputs hold."""
        return sorted({self.key(lane) for batch in self.plan.batches for lane in batch})

    def reference_srs(self) -> ToySrs:
        return ToySrs.load(self.srs_path, self.trapdoor_seed)

    def reference_map(self, job: str, decide: bool = True) -> Dict[tuple, object]:
        """`job` ("verdict": the accept bit; "accumulator": the one
        accumulator of the succinct verification) of every distinct lane
        content, by the reference."""
        keys = self.keys()
        args = [(job, decide, self.content(k)) for k in keys]
        init = (str(self.protocol_path), str(self.srs_path), self.trapdoor_seed, self.scheme,
                self.transcript)
        workers = max(1, min(6, (os.cpu_count() or 2) - 1, len(args) // 16))
        if workers == 1:
            _init(*init)
            got = [_work(a) for a in args]
        else:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init,
                                     initargs=init) as ex:
                got = list(ex.map(_work, args, chunksize=max(1, len(args) // (4 * workers))))
        return dict(zip(keys, got))


_STATE = {}


def _init(protocol_path, srs_path, trapdoor_seed, scheme, transcript):
    with open(protocol_path) as f:
        _STATE["protocol"] = RefProtocol.from_json(json.load(f))
    _STATE["srs"] = ToySrs.load(srs_path, trapdoor_seed)
    _STATE["scheme"], _STATE["transcript"] = scheme, transcript


def _work(arg):
    job, decide, content = arg
    s = RefSnark(_STATE["protocol"], *content)
    srs = _STATE["srs"]
    if job == "verdict":
        return reference.verdict(s, srs, _STATE["scheme"], _STATE["transcript"], decide)
    accs = reference.succinct_verify(s, srs.g, _STATE["scheme"], _STATE["transcript"])
    if len(accs) != 1:
        raise ValueError("the tree's reference folds one accumulator a leaf")
    return accs[0]
