"""halo2 `VerifyingKey::transcript_repr` — the vk digest that seeds the
Fiat–Shamir transcript: the counterpart of the JAX package's
`system/vk_digest.py` (host hashing only).

The reference extracts it with a mock transcript
(its system/halo2.rs:686-722:
`transcript_initial_state(vk)` = `vk.hash_into(MockTranscript)` = the vk's
`transcript_repr` scalar).  halo2_proofs computes that scalar as:

    hasher = blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    s = format!("{:?}", vk.pinned())          # Debug of PinnedVerificationKey
    hasher.update(u64_le(len(s)))
    hasher.update(s)
    transcript_repr = Fr::from_bytes_wide(hasher.finalize())   # 512-bit LE mod r

This module implements the digest pipeline exactly (blake2b personalization,
u64 length prefix, 512-bit little-endian reduction) plus a builder for the
pinned-vk Debug string's outer grammar.  The full `PinnedConstraintSystem`
Debug grammar depends on halo2_proofs internals that cannot be byte-checked
without a reference artifact in this image — callers importing a real vk
should pass the pinned string captured from halo2 (`format!("{:?}",
vk.pinned())`) to `transcript_repr`, which then yields the exact
`transcript_initial_state` the reference proof stream was built with.  See
INTEROP.md for the byte contract.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from ..ff.spec import FQ, FR

PERSONALIZATION = b"Halo2-Verify-Key"


def fr_from_bytes_wide(b: bytes) -> int:
    """halo2curves `Fr::from_bytes_wide`: 64 little-endian bytes reduced
    mod r (the Montgomery folding it uses is mathematically plain mod)."""
    if len(b) != 64:
        raise ValueError(f"from_bytes_wide takes 64 bytes, not {len(b)}")
    return int.from_bytes(b, "little") % FR.p


def transcript_repr(pinned_vk_debug: str) -> int:
    """The vk digest scalar from the pinned-vk Debug string (see module
    docstring; this is the value `PlonkProtocol.transcript_initial_state`
    must hold to verify proofs produced against that vk)."""
    h = hashlib.blake2b(digest_size=64, person=PERSONALIZATION)
    s = pinned_vk_debug.encode()
    h.update(len(s).to_bytes(8, "little"))
    h.update(s)
    return fr_from_bytes_wide(h.digest())


# ------------------------------------------------ pinned-vk string builder

BASE_MODULUS = "0x" + format(FQ.p, "064x")
SCALAR_MODULUS = "0x" + format(FR.p, "064x")


def fmt_field(v: int) -> str:
    """halo2curves field Debug: 0x-prefixed 64-hex-digit canonical value."""
    return "0x" + format(v % FR.p, "064x")


def fmt_fq(v: int) -> str:
    return "0x" + format(v % FQ.p, "064x")


def fmt_point(pt: Tuple[int, int]) -> str:
    """halo2curves affine-point Debug: `(x, y)` coordinate pair."""
    return f"({fmt_fq(pt[0])}, {fmt_fq(pt[1])})"


def pinned_vk_string(
    k: int,
    extended_k: int,
    omega: int,
    cs_debug: str,
    fixed_commitments: Sequence[Tuple[int, int]],
    permutation_commitments: Sequence[Tuple[int, int]],
) -> str:
    """The outer `PinnedVerificationKey` Debug grammar (halo2_proofs
    plonk/keygen; Rust derive-Debug non-alternate formatting):

        PinnedVerificationKey { base_modulus: "..", scalar_modulus: "..",
          domain: PinnedEvaluationDomain { k: .., extended_k: .., omega: .. },
          cs: PinnedConstraintSystem { .. }, fixed_commitments: [..],
          permutation: VerifyingKey { commitments: [..] } }

    `cs_debug` is the `PinnedConstraintSystem { .. }` fragment — build it
    with `pinned_cs_string` for repo-native circuits, or capture it from
    halo2 for imported vks."""
    fixed = "[" + ", ".join(fmt_point(p) for p in fixed_commitments) + "]"
    perm = "[" + ", ".join(fmt_point(p) for p in permutation_commitments) + "]"
    return (
        "PinnedVerificationKey { "
        f'base_modulus: "{BASE_MODULUS}", '
        f'scalar_modulus: "{SCALAR_MODULUS}", '
        f"domain: PinnedEvaluationDomain {{ k: {k}, extended_k: {extended_k}, "
        f"omega: {fmt_field(omega)} }}, "
        f"cs: {cs_debug}, "
        f"fixed_commitments: {fixed}, "
        f"permutation: VerifyingKey {{ commitments: {perm} }} }}"
    )


def pinned_cs_string(
    num_fixed_columns: int,
    num_advice_columns: int,
    num_instance_columns: int,
    num_selectors: int = 0,
    gates: Sequence[str] = (),
    advice_queries: Sequence[Tuple[int, int]] = (),
    instance_queries: Sequence[Tuple[int, int]] = (),
    fixed_queries: Sequence[Tuple[int, int]] = (),
    permutation_columns: Sequence[str] = (),
    lookups: Sequence[str] = (),
    constants: Sequence[str] = (),
    minimum_degree: Optional[int] = None,
) -> str:
    """`PinnedConstraintSystem` Debug fragment for repo-native circuits.
    Queries are (column_index, rotation) rendered in halo2's
    `(Column { index: i, column_type: T }, Rotation(r))` form by the caller
    through `fmt_query`; gate/lookup expression strings likewise follow
    halo2's `Expression` Debug."""

    def lst(xs):
        return "[" + ", ".join(str(x) for x in xs) + "]"

    md = "None" if minimum_degree is None else f"Some({minimum_degree})"
    return (
        "PinnedConstraintSystem { "
        f"num_fixed_columns: {num_fixed_columns}, "
        f"num_advice_columns: {num_advice_columns}, "
        f"num_instance_columns: {num_instance_columns}, "
        f"num_selectors: {num_selectors}, "
        f"gates: {lst(gates)}, "
        f"advice_queries: {lst(advice_queries)}, "
        f"instance_queries: {lst(instance_queries)}, "
        f"fixed_queries: {lst(fixed_queries)}, "
        f"permutation: Argument {{ columns: {lst(permutation_columns)} }}, "
        f"lookups: {lst(lookups)}, "
        f"constants: {lst(constants)}, "
        f"minimum_degree: {md} }}"
    )


def fmt_query(column_index: int, column_type: str, rotation: int) -> str:
    """halo2 query Debug: (Column { .. }, Rotation(r))."""
    return (
        f"(Column {{ index: {column_index}, column_type: {column_type} }}, "
        f"Rotation({rotation}))"
    )
