"""The KZG accumulation scheme's fold in python ints (the reference's
accumulation.rs create_proof :146-195, without a blind) and the two-level
grouping of the port's `KzgAs.fold_hierarchical`, which is part of the
transcript's definition: N accumulators in groups of the largest divisor
of N in [2, 32] (N > 32), each group folded under its own transcript, then
the fold of the group accumulators; N ≤ 32, or N without such a divisor,
folds once."""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import py_ec
from .fields import FR
from .transcript import PoseidonTranscriptPy

MAX_CHAIN = 32


def fold(accs: List[Tuple]):
    """[(lhs, rhs)] affine int accumulators -> their fold (lhs, rhs): every
    point absorbed into a fresh Poseidon transcript (lhs₀, rhs₀, lhs₁, …),
    r squeezed, (Σ rⁱ·lhsᵢ, Σ rⁱ·rhsᵢ)."""
    if not accs:
        raise ValueError("fold: no accumulator")
    t = PoseidonTranscriptPy()
    for lhs, rhs in accs:
        t.common_ec_point(lhs)
        t.common_ec_point(rhs)
    r = t.squeeze_challenge()
    weights = [1]
    for _ in accs[1:]:
        weights.append(weights[-1] * r % FR.p)
    return (py_ec.msm([l for l, _ in accs], weights),
            py_ec.msm([rh for _, rh in accs], weights))


def group_size(n: int) -> Optional[int]:
    g = max((d for d in range(2, min(MAX_CHAIN, n - 1) + 1) if n % d == 0), default=None)
    return None if g is None or n <= MAX_CHAIN else g


def fold_hierarchical(accs: List[Tuple]):
    g = group_size(len(accs))
    if g is not None:
        accs = [fold(accs[i : i + g]) for i in range(0, len(accs), g)]
    return fold(accs)
