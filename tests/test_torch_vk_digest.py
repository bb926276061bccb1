"""The port's halo2 vk digest (`system/vk_digest.py`) against the JAX
package's: `fr_from_bytes_wide` on numpy-seeded 64-byte strings (and its
refusal of another length), the field and point formatters, the pinned
constraint-system and pinned-vk strings of a numpy-seeded key, and
`transcript_repr` of those strings and of fixed ones.

Tolerance: exact (strings, python ints)."""

import numpy as np
import pytest

from snark_verifier_tpu.ec import py_ec as JEC
from snark_verifier_tpu.system import vk_digest as J
from snark_verifier_tpu_torch.system import vk_digest as P


def test_wide_reduction_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        b = rng.bytes(64)
        assert P.fr_from_bytes_wide(b) == J.fr_from_bytes_wide(b)
    assert P.fr_from_bytes_wide(b"\xff" * 64) == J.fr_from_bytes_wide(b"\xff" * 64)
    with pytest.raises(ValueError):
        P.fr_from_bytes_wide(bytes(32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pinned_strings_and_digest_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = JEC.rand_points(5, seed=seed)
    v = int.from_bytes(rng.bytes(32), "little")
    assert P.fmt_field(v) == J.fmt_field(v) and P.fmt_fq(v) == J.fmt_fq(v)
    assert P.fmt_point(pts[0]) == J.fmt_point(pts[0])
    q = [P.fmt_query(i, "Advice", r) for i, r in ((0, 0), (1, -1), (2, 1))]
    assert q == [J.fmt_query(i, "Advice", r) for i, r in ((0, 0), (1, -1), (2, 1))]
    kw = dict(num_fixed_columns=int(rng.integers(1, 9)), num_advice_columns=3,
              num_instance_columns=1, num_selectors=2, gates=["Product(a, b)"],
              advice_queries=q, instance_queries=q[:1], fixed_queries=q[1:],
              permutation_columns=["Column { index: 0, column_type: Advice }"],
              lookups=["Argument { .. }"], constants=[], minimum_degree=seed or None)
    cs = P.pinned_cs_string(**kw)
    assert cs == J.pinned_cs_string(**kw)
    omega = int.from_bytes(rng.bytes(32), "little")
    vk = P.pinned_vk_string(seed + 4, seed + 6, omega, cs, pts[:3], pts[3:])
    assert vk == J.pinned_vk_string(seed + 4, seed + 6, omega, cs, pts[:3], pts[3:])
    assert P.transcript_repr(vk) == J.transcript_repr(vk)
    assert P.transcript_repr("") == J.transcript_repr("")
    assert (P.BASE_MODULUS, P.SCALAR_MODULUS) == (J.BASE_MODULUS, J.SCALAR_MODULUS)
