"""Two-layer recursive aggregation on one card: the counterpart of the JAX
package's `sdk/tree_aggregation.py` (`_fold` :30, `tree_aggregate` :50, and
`_build_sharded` :114-174 on a one-device mesh, which is what
`bench.py::bench_tree` runs).  The reference's recursion example
(examples/recursion.rs): leaves are application proofs, inner nodes verify
and fold, the root is one pairing check.

  * `tree_aggregate` — the local tree: groups of `fanout` leaves, each group
    verified as one batch and folded by the list path, then the fold of the
    group accumulators.
  * `tree_aggregate_root` — layer 1, the whole batch verified at once and its
    accumulators folded by `KzgAs.fold_hierarchical`; layer 2, the fold of
    that one accumulator with its own transcript (the JAX package's
    all-gather over a mesh of one device, then `fold_hierarchical` at
    N = 1); then one decide.  The mesh of several cards waits for the
    port's multi-card work.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..pcs.kzg.accumulation import KzgAs, fold_transcript
from ..pcs.kzg.decider import decide
from .aggregation import _step, batch_succinct_verify, stack_pairs


def _fold(accs: List[Tuple]):
    """The list-path fold of [(lhs, rhs)] projective points with a fresh
    transcript, no blind: points (B, 3, 8) fold per lane, (3, 8) alone."""
    single = accs[0][0].dim() == 2
    if single:
        accs = [(lhs[None], rhs[None]) for lhs, rhs in accs]
    td = fold_transcript(accs[0][0].shape[0], accs[0][0].device)
    lhs, rhs = KzgAs.verify(accs, KzgAs.read_proof(False, accs, td))
    return (lhs[0], rhs[0]) if single else (lhs, rhs)


def tree_aggregate(snarks: Sequence, srs, scheme_name: str = "shplonk", fanout: int = 8,
                   device=None):
    """Groups of `fanout` leaves -> group accumulators -> the root (lhs, rhs),
    each (3, 8).  Each group's accumulators enter its fold
    accumulator-major."""
    dev = resolve_device(device)
    group_accs = []
    for i in range(0, len(snarks), fanout):
        g = snarks[i : i + fanout]
        accs = batch_succinct_verify(g, srs, scheme_name, device=dev)
        group_accs.append(_fold([(lhs[b], rhs[b]) for lhs, rhs in accs for b in range(len(g))]))
    return _fold(group_accs)


def tree_aggregate_root(snarks: Sequence, srs, scheme_name: str = "shplonk", device=None,
                        timings: dict = None):
    """The 1-card tree of `bench.py::bench_tree` -> (root_lhs, root_rhs, ok):
    each root side (3, 8), ok a 0-dim bool, the root's one pairing check.

    `timings`, when given, gets the host seconds of each phase, each ended by
    a synchronize: the succinct phase's steps and `succinct_s`, layer 1's
    `fold_groups_s` (where the batch has more than 32 accumulators) and
    `fold_top_s`, layer 2's `fold_root_s`, and `decide_s`."""
    dev = resolve_device(device)

    def step(key, fn):
        return _step(timings, key, dev, fn)

    accs = step("succinct_s", lambda: batch_succinct_verify(snarks, srs, scheme_name,
                                                            device=dev, timings=timings))
    lhs, rhs = KzgAs.fold_hierarchical(stack_pairs(accs), step=step)
    root_l, root_r = step("fold_root_s",
                          lambda: KzgAs.fold_hierarchical(torch.stack([lhs, rhs], 0)[None]))
    ok = step("decide_s", lambda: decide(srs, root_l, root_r))
    return root_l, root_r, ok
