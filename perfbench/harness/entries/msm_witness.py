"""One commitment of a witness column as one call: `msm_commit.Entry`
(the same bases, call, reference sum and control), with the scalar
vectors of the degree-21 aggregation circuit's witness columns in place
of uniform ones.

The traffic's `columns` names how many vectors are advice columns and how
many lookup-advice columns, cycled in that order.  An advice column is a
sequence of runs, each of `run_rows` rows (drawn uniformly) holding one
value, drawn by the shares of `advice`: below 2^88 (a limb), uniform in
[0, r), below 2^20 (a lookup-sized value), zero, one.  A lookup-advice
column holds values uniform below 2^20, zero by the share `lookup.zero`.
Everything is drawn on the device by one torch.Generator seeded from the
run's seed (`traffic.msm_scalar_seed`)."""

from __future__ import annotations

import importlib

import torch

from .. import traffic as tr
from . import msm_commit

KINDS = ("below_2_88", "uniform", "below_2_20", "zero", "one")


def _below(m: int, bits: int, gen, device):
    """(m, 16) canonical limbs uniform below 2^bits."""
    limbs = torch.randint(0, 1 << 16, (m, 16), generator=gen, device=device, dtype=torch.int64)
    whole, part = divmod(bits, 16)
    if part:
        limbs[:, whole] &= (1 << part) - 1
        whole += 1
    limbs[:, whole:] = 0
    return limbs


def _uniform(m: int, gen, device):
    """(m, 16) canonical limbs uniform in [0, r): 254-bit draws, those ≥ r
    (compared on their top 64 bits, equality rejected too) drawn again."""
    r_top = sum(int(msm_commit.R_LIMBS[12 + j]) << (16 * j) for j in range(4))
    got, need = [], m
    while need > 0:
        limbs = _below(need + need // 3 + 1024, 254, gen, device)
        top = limbs[:, 12] | (limbs[:, 13] << 16) | (limbs[:, 14] << 32) | (limbs[:, 15] << 48)
        got.append(limbs[top < r_top][:need])
        need -= len(got[-1])
    return torch.cat(got)


def advice_column(n: int, shares: dict, run_rows, gen, device):
    """(n, 16) limbs: runs of `run_rows` = [lo, hi] equal rows, each run's
    value of the kind its draw picks by `shares`."""
    lo, hi = (int(v) for v in run_rows)
    m = 2 * n // (lo + hi) + n // 16 + 1024  # runs enough to cover n rows
    lengths = torch.randint(lo, hi + 1, (m,), generator=gen, device=device)
    bounds = torch.cumsum(torch.tensor([float(shares[k]) for k in KINDS], dtype=torch.float64,
                                       device=device), 0)
    kind = torch.bucketize(torch.rand(m, generator=gen, device=device, dtype=torch.float64),
                           bounds, right=True).clamp(max=len(KINDS) - 1)
    values = torch.zeros((m, 16), dtype=torch.int64, device=device)
    for k, name in enumerate(KINDS):
        at = (kind == k).nonzero().squeeze(1)
        if name == "below_2_88":
            values[at] = _below(len(at), 88, gen, device)
        elif name == "uniform":
            values[at] = _uniform(len(at), gen, device)
        elif name == "below_2_20":
            values[at] = _below(len(at), 20, gen, device)
        elif name == "one":
            values[at, 0] = 1
    rows = torch.repeat_interleave(values, lengths, dim=0)
    if rows.shape[0] < n:
        raise ValueError(f"{rows.shape[0]} rows of runs for a column of {n}")
    return rows[:n].contiguous()


def lookup_column(n: int, zero: float, gen, device):
    """(n, 16) limbs uniform below 2^20, each zero by the share `zero`."""
    limbs = _below(n, 20, gen, device)
    limbs[torch.rand(n, generator=gen, device=device) < float(zero)] = 0
    return limbs


def make_witness_scalars(n: int, traffic: dict, seed: int, device):
    """The traffic's vectors: `columns["advice"]` advice columns, then
    `columns["lookup_advice"]` lookup-advice columns."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = traffic["columns"]
    out = [advice_column(n, traffic["advice"], traffic["advice"]["run_rows"], gen, device)
           for _ in range(int(cols["advice"]))]
    out += [lookup_column(n, traffic["lookup"]["zero"], gen, device)
            for _ in range(int(cols["lookup_advice"]))]
    if len(out) != int(traffic["vectors"]):
        raise ValueError(f"{len(out)} columns for {traffic['vectors']} vectors")
    return out


class Entry(msm_commit.Entry):
    def setup(self):
        """`msm_commit.Entry.setup` with the witness vectors."""
        run = self.run
        self.program = importlib.import_module(msm_commit.PROGRAM)
        n = int(run.config["n"])
        self.a, self.d = tr.msm_base_params(run.seed, n)
        self.bases = msm_commit.make_bases(n, self.a, self.d, self.device)
        self.scalars = make_witness_scalars(n, run.traffic, tr.msm_scalar_seed(run.seed),
                                            self.device)
