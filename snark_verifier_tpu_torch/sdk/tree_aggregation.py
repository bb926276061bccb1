"""Two-layer recursive aggregation: the counterpart of the JAX package's
`sdk/tree_aggregation.py` (`_fold` :30, `tree_aggregate` :50,
`tree_aggregate_sharded` :74, `tree_comm_inventory` :84, `_build_sharded`
:114).  The reference's recursion example (examples/recursion.rs): leaves
are application proofs, inner nodes verify and fold, the root is one
pairing check.

  * `tree_aggregate` — the local tree: groups of `fanout` leaves, each group
    verified as one batch and folded by the list path, then the fold of the
    group accumulators.
  * `tree_aggregate_sharded` — layer 1 on each device of the mesh axis, its
    shard of leaves verified and folded accumulator-major by
    `KzgAs.fold_hierarchical`; layer 2 gathers the D shard accumulators
    (`parallel.mesh.all_gather`, two gathers: every lhs, every rhs) and
    folds them by `fold_hierarchical` at N = D on the mesh's first device;
    then one decide.  Its root depends on D: at 1,024 leaves over 4 devices
    each shard folds 8 groups of 32, then 8, and the root folds 4.
    `tree_comm_inventory` records layer 2's gathers, the tree's only
    communication.
  * `tree_aggregate_root` — the same tree on a mesh of one device, what
    `bench.py::bench_tree` runs: layer 2 folds the one accumulator with its
    own transcript (N = 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..msm import cuda_ops
from ..parallel.comm_model import collective_inventory
from ..parallel.mesh import Mesh, all_gather, split
from ..pcs.kzg.accumulation import KzgAs, fold_transcript
from ..pcs.kzg.decider import decide
from ..utils.timing import _step
from .aggregation import batch_succinct_verify, stack_pairs


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
    It is `tree_aggregate_sharded` on a mesh of that one device, timings
    included."""
    return _build_sharded(snarks, srs, Mesh([resolve_device(device)], ("batch",)),
                          scheme_name)(timings)


def _layer2(parts, line: Mesh, axis_name: str):
    """Gather the D shard accumulators [(lhs, rhs)], each (3, 8) on its
    device, onto the mesh's first device and fold them at N = D."""
    lhs = all_gather([l for l, _ in parts], line, axis_name).item()  # (D, 3, 8)
    rhs = all_gather([r for _, r in parts], line, axis_name).item()
    return KzgAs.fold_hierarchical(torch.stack([lhs, rhs], 1))


def _build_sharded(snarks: Sequence, srs, mesh: Mesh, scheme_name: str = "shplonk",
                   axis_name: str = "batch"):
    """-> run(timings=None): the two-layer tree of `snarks` over the devices
    of mesh axis `axis_name` (the leaves must divide by the axis's size).
    A run is the span "svt::tree", its phases "svt::tree.succinct", the
    fold levels ("svt::fold.groups", "svt::fold.top", layer 2's
    "svt::fold.root") and "svt::tree.decide" (`utils.timing`)."""
    if not snarks:
        raise ValueError("tree_aggregate_sharded: no leaf")
    line = mesh.along(axis_name)
    devices = list(line.devices.flat)
    shards = split(list(snarks), line, axis_name)

    def run(timings=None):
        def tree():
            accs = _step("tree.succinct", lambda: [
                batch_succinct_verify(part, srs, scheme_name, device=dev, timings=timings)
                for part, dev in zip(shards, devices)], timings, "succinct_s", line)
            # layer 1: each device folds its shard, accumulator-major
            parts = [KzgAs.fold_hierarchical(stack_pairs(a), timings) for a in accs]
            root_l, root_r = _step("fold.root", lambda: _layer2(parts, line, axis_name),
                                   timings, "fold_root_s", line)
            ok = _step("tree.decide", lambda: decide(srs, root_l, root_r), timings, "decide_s",
                       line)
            return root_l, root_r, ok

        return _step("tree", tree)

    return run


def tree_aggregate_sharded(snarks: Sequence, srs, mesh: Mesh, scheme_name: str = "shplonk",
                           axis_name: str = "batch", timings: dict = None):
    """The two-layer tree over mesh axis `axis_name` -> (root_lhs, root_rhs,
    ok) on the mesh's first device: each root side (3, 8), ok a 0-dim bool,
    the root's one pairing check.  `timings`, when given, gets the host
    seconds of each phase summed over the shards, each ended by a
    synchronize (of the shard's device for a shard's steps, else of every
    device): the succinct phase's steps and `succinct_s`; layer 1's
    `fold_groups_s` (where a shard has more than 32 accumulators) and
    `fold_top_s`; layer 2's `fold_root_s` (its gathers and fold);
    `decide_s`."""
    return _build_sharded(snarks, srs, mesh, scheme_name, axis_name)(timings)


def tree_comm_inventory(snarks: Sequence, srs, mesh: Mesh, scheme_name: str = "shplonk",
                        axis_name: str = "batch"):
    """The collective inventory of the sharded tree: layer 1 is data-parallel
    with no communication, so layer 2 (the gathers of the D shard
    accumulators and the root fold) accounts every byte the whole tree
    moves.  The port records by running: layer 2 runs on D identity
    accumulators, one on each device (the gathers' shapes do not depend on
    the values), and equals the inventory of a whole
    `tree_aggregate_sharded` run."""
    line = mesh.along(axis_name)
    split(list(snarks), line, axis_name)  # the leaves must divide, as the tree's
    parts = [tuple(cuda_ops.identity((2,), d)) for d in line.devices.flat]
    return collective_inventory(_layer2, parts, line, axis_name)
