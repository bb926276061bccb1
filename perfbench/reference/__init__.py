"""The benchmark's plain reference: the verification semantics of the
program under test in python ints, independent of it.

Frozen copies of the port's host oracle (the verifier, SHPLONK and GWC19,
the two transcripts, Poseidon, keccak, G1, the accumulation fold), trimmed
to the python-int path; it imports no torch and nothing of the program, and
takes from the benchmark only the inputs both sides are given."""

from __future__ import annotations

from .accumulation import fold, fold_hierarchical
from .snark import Snark
from .srs import ToySrs
from .verifier import succinct_verify


def verdict(snark: Snark, srs: ToySrs, scheme: str = "shplonk", transcript: str = "poseidon",
            decide: bool = True) -> bool:
    """The accept bit of one proof: its succinct verification, then the
    decider on every accumulator (`decide=False` skips the decider: the
    benchmark's control, a verifier that accepts whatever it can read)."""
    accs = succinct_verify(snark, srs.g, scheme, transcript)
    return all(srs.decide(l, r) for l, r in accs) if decide else True


def tree_root(accs, srs: ToySrs, decide: bool = True):
    """The root of the two-layer tree over the leaves' accumulators (layer
    1 `fold_hierarchical`, layer 2 the fold of its one accumulator) ->
    (lhs, rhs, accept bit)."""
    lhs, rhs = fold([fold_hierarchical(accs)])
    return lhs, rhs, (srs.decide(lhs, rhs) if decide else True)


__all__ = ["Snark", "ToySrs", "fold", "fold_hierarchical", "succinct_verify", "tree_root",
           "verdict"]
