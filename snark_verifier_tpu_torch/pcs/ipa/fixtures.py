"""The committed IPA proofs (`snark_verifier_tpu_torch/fixtures/ipa_*.json`)
and their compact codec: an Fr value is 64 hex digits, an affine G1 point
128 (x then y), each big-endian.

  * `ipa_key_k11.json`: the 2^11 bases G, H and the zk base S of one key
    (k = 11, the circuit size of Zcash Orchard's action circuit); the key
    without zk is the same G and H without S;
  * `ipa_openings_k11.json`: 16 openings p(z) = v without zk and 16 with;
  * `ipa_bgh19_k11.json`: 4 BGH19 multiopens (3 polynomials, queries at x
    and 7x), without zk;
  * `ipa_as_k11.json`: two IpaAs folds, of the 16 accumulators of the
    openings without zk and of 4 accumulators with zk.

Each proof carries the prover's accumulator (ξ and U).  The files are made
by the JAX package's host provers: `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_ipa.py` rewrites them, and a tier-1 test holds them to
those provers.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import List, Tuple

from .ipa import IpaAccumulator, IpaDecidingKey, IpaProvingKey, IpaSuccinctVerifyingKey
from .plan import Bgh19Opening, IpaFold, IpaOpening

FIXTURES = Path(__file__).resolve().parents[2] / "fixtures"
K = 11


def fr_hex(v: int) -> str:
    return f"{v:064x}"


def pt_hex(pt) -> str:
    return f"{pt[0]:064x}{pt[1]:064x}"


def hex_fr(s: str) -> int:
    return int(s, 16)


def hex_pt(s: str) -> Tuple[int, int]:
    return int(s[:64], 16), int(s[64:], 16)


def acc_to_json(acc: IpaAccumulator) -> dict:
    return {"xi": [fr_hex(x) for x in acc.xi], "u": pt_hex(acc.u)}


def acc_from_json(d) -> IpaAccumulator:
    return IpaAccumulator([hex_fr(x) for x in d["xi"]], hex_pt(d["u"]))


def streams_to_json(scalars, points) -> dict:
    return {"scalars": [fr_hex(s) for s in scalars], "points": [pt_hex(p) for p in points]}


def _streams(d):
    return [hex_fr(s) for s in d["scalars"]], [hex_pt(p) for p in d["points"]]


def _load(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


@functools.lru_cache(maxsize=None)
def ipa_proving_key() -> IpaProvingKey:
    """The committed key with zk (G, H and S); the key without zk is
    `IpaProvingKey(k, g, h)`."""
    d = _load(f"ipa_key_k{K}.json")
    return IpaProvingKey(d["k"], [hex_pt(p) for p in d["g"]], hex_pt(d["h"]), hex_pt(d["s"]))


@functools.lru_cache(maxsize=None)
def ipa_keys() -> Tuple[IpaDecidingKey, IpaDecidingKey]:
    """(the deciding key without zk, the one with zk): one G and H."""
    d = _load(f"ipa_key_k{K}.json")
    g = [hex_pt(p) for p in d["g"]]
    h, s = hex_pt(d["h"]), hex_pt(d["s"])
    return (IpaDecidingKey(IpaSuccinctVerifyingKey(d["k"], g[0], h), g),
            IpaDecidingKey(IpaSuccinctVerifyingKey(d["k"], g[0], h, s), g))


def ipa_openings(zk: bool) -> Tuple[List[IpaOpening], List[IpaAccumulator]]:
    """The 16 openings (one key object, shared) and the prover's
    accumulators."""
    svk = ipa_keys()[zk].svk
    items = _load(f"ipa_openings_k{K}.json")["zk" if zk else "plain"]
    return ([IpaOpening(svk, hex_pt(d["c"]), hex_fr(d["z"]), hex_fr(d["v"]), *_streams(d))
             for d in items], [acc_from_json(d["acc"]) for d in items])


def bgh19_openings() -> Tuple[List[Bgh19Opening], List[IpaAccumulator]]:
    svk = ipa_keys()[0].svk
    items = _load(f"ipa_bgh19_k{K}.json")["openings"]
    return ([Bgh19Opening(svk, [hex_pt(c) for c in d["commitments"]], hex_fr(d["x"]),
                          [(p, sh, hex_fr(ev)) for p, sh, ev in d["queries"]], *_streams(d))
             for d in items], [acc_from_json(d["acc"]) for d in items])


def ipa_folds() -> Tuple[List[IpaFold], List[IpaAccumulator]]:
    """The two folds (without zk, of 16; with zk, of 4) and the prover's
    folded accumulators."""
    folds, accs = [], []
    for d in _load(f"ipa_as_k{K}.json")["folds"]:
        svk = ipa_keys()[d["zk"]].svk
        folds.append(IpaFold(svk, [acc_from_json(a) for a in d["accs"]], *_streams(d)))
        accs.append(acc_from_json(d["acc"]))
    return folds, accs
