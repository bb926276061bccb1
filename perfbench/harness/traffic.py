"""The one generator of the benchmark's traffic: a traffic file's
parameters and the run's seed -> the run's inputs, the same for the same
seed, every seed the same sizes in another order.

Proof lanes ("proof_lanes"): `batches` batches of `lanes` proofs from the
configuration's pool of the traffic's `transcript`, each batch the pool in
an order drawn from the seed (shuffled again each time round where the
batch is longer than the pool), so no proof repeats in a batch the pool
can fill; in `tampered_batches`
of them (chosen from the seed) `tampers_per_batch` lanes (chosen from the
seed) carry one of `tamper_variants` tampered proofs.  A variant is a
fixture with one value moved, its kind taking `kinds` in turn: an
instance, a proof scalar (each + a nonzero delta mod r), or a proof point
(+ m·G, still on the curve).  Every variant appears at least once when
there are as many tampered lanes as variants.

MSM scalars ("msm_scalars"): `vectors` vectors of `n` scalars uniform in
[0, r), made on the device by a torch.Generator seeded from the seed; the
bases are (a + (i + 2^11)·d)·G for i < n with a, d drawn from the seed."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from reference import py_ec
from reference.fields import FR


@dataclass(frozen=True)
class Tamper:
    fixture: int
    kind: str  # "instance" | "scalar" | "point"
    index: int
    delta: int  # added mod r; for a point, the multiple of G added

    def apply(self, instances, scalars, points) -> Tuple[list, list, list]:
        """-> new (instances, scalars, points) python-int lists."""
        inst = [list(c) for c in instances]
        sc, pts = list(scalars), list(points)
        if self.kind == "instance":
            flat = [(i, j) for i, c in enumerate(inst) for j in range(len(c))]
            i, j = flat[self.index % len(flat)]
            inst[i][j] = (inst[i][j] + self.delta) % FR.p
        elif self.kind == "scalar":
            k = self.index % len(sc)
            sc[k] = (sc[k] + self.delta) % FR.p
        elif self.kind == "point":
            k = self.index % len(pts)
            pts[k] = py_ec.add(pts[k], py_ec.scalar_mul(py_ec.G1_GEN, self.delta))
        else:
            raise ValueError(f"unknown tamper kind {self.kind!r}")
        return inst, sc, pts


@dataclass
class ProofLanes:
    """batches[b][lane] = (fixture index, tamper variant index or None)."""

    batches: List[List[Tuple[int, Optional[int]]]]
    variants: List[Tamper]


def _rng(seed: int, salt: str) -> random.Random:
    return random.Random(f"{salt}:{int(seed)}")


def _orders(rng: random.Random, n: int, lanes: int) -> List[int]:
    """`lanes` pool indices: shuffled copies of range(n), end to end."""
    out = []
    while len(out) < lanes:
        block = list(range(n))
        rng.shuffle(block)
        out.extend(block)
    return out[:lanes]


def proof_lanes(params: dict, seed: int, n_fixtures: int) -> ProofLanes:
    rng = _rng(seed, "proof_lanes")
    lanes, n_batches = int(params["lanes"]), int(params["batches"])
    kinds = list(params.get("kinds", ["instance", "scalar", "point"]))
    rng.shuffle(kinds)
    n_var = int(params.get("tamper_variants", 0))
    per = int(params.get("tampers_per_batch", 0))
    n_tb = int(params.get("tampered_batches", n_batches))
    if per > lanes or n_tb > n_batches or (per and not n_var):
        raise ValueError(f"inconsistent traffic parameters {params}")
    variants = [Tamper(rng.randrange(n_fixtures), kinds[v % len(kinds)], rng.randrange(1 << 16),
                       rng.randrange(1, FR.p) if kinds[v % len(kinds)] != "point"
                       else rng.randrange(1, 1 << 16))
                for v in range(n_var)]
    batches = [[(f, None) for f in _orders(rng, n_fixtures, lanes)] for _ in range(n_batches)]
    order = list(range(n_var))
    rng.shuffle(order)
    slot = 0
    for b in sorted(rng.sample(range(n_batches), n_tb)):
        for lane in sorted(rng.sample(range(lanes), per)):
            v = order[slot % n_var]
            slot += 1
            batches[b][lane] = (variants[v].fixture, v)
    return ProofLanes(batches, variants)


def msm_base_params(seed: int, n: int, lo_bits: int = 11) -> Tuple[int, int]:
    """(a, d) of the bases (a + (i + 2^lo_bits)·d)·G, drawn until no base is
    the identity and no two table points the bases add are equal or
    opposite (q = a/d outside ±(n + 2^(lo_bits + 2)))."""
    rng = _rng(seed, "msm_bases")
    guard = n + (1 << (lo_bits + 2))
    while True:
        a, d = rng.randrange(1, FR.p), rng.randrange(1, FR.p)
        q = a * pow(d, -1, FR.p) % FR.p
        if guard < q < FR.p - guard:
            return a, d


def msm_scalar_seed(seed: int) -> int:
    """The torch.Generator seed of the scalar vectors (a 63-bit int)."""
    return _rng(seed, "msm_scalars").getrandbits(63)
