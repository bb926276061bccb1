"""The port's KZG accumulation fold (pcs/kzg/accumulation.py, device="cpu":
every kernel's plain version) against the JAX package: the stacked fold,
the list fold and the port's python-int prover against JAX
`KzgAs.create_proof` at N = 1 and 5; `fold_hierarchical` at N = 64 (2
groups of 32, then the root) and N = 35 (5 groups of 7) against the same
groups replayed with fresh JAX `PoseidonTranscriptPy`s; the stacked absorb
against JAX `absorb_ec_points_scanned` (`PoseidonJax.update_chunks_scanned`)
and `PoseidonPy`; `powers_plain` against JAX `_powers_stack`; the
accumulator limb codec against the JAX package's; and a lane of identity
accumulators against the JAX device path's rule (the identity absorbed as
(0, 0)).

Inputs are made with numpy from a seed.  Tolerance: exact (affine ints,
canonical values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import py_ec as jpy_ec
from snark_verifier_tpu.ff import FQ_FIELD as JFQ, FR_FIELD as JFR
from snark_verifier_tpu.hash.poseidon import PoseidonPy
from snark_verifier_tpu.pcs.kzg import accumulator as jacc
from snark_verifier_tpu.pcs.kzg.accumulation import KzgAs as JKzgAs, _powers_stack
from snark_verifier_tpu.transcript import PoseidonTranscript as JPoseidonTranscript
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FQW, FR, FRW, limbs_to_int
from snark_verifier_tpu_torch.pcs.kzg import accumulator as acc
from snark_verifier_tpu_torch.pcs.kzg.accumulation import (
    KzgAs,
    fold_transcript,
    powers,
    powers_plain,
)
from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_pairs(n, seed):
    """n (lhs, rhs) affine int accumulators, small multiples of G (as
    test_fold_stacked.py's)."""
    rng = np.random.default_rng(seed)
    pts = [jpy_ec.scalar_mul(jpy_ec.G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(2 * n)]
    return [(pts[2 * i], pts[2 * i + 1]) for i in range(n)]


def _stack(pairs):
    """[(lhs, rhs)] affine ints -> (N, 2, 3, 8) projective words."""
    flat = from_affine_int([p for pair in pairs for p in pair])
    return limbs_to_words(flat).reshape(len(pairs), 2, 3, 8)


def _affine(pt):
    return to_affine_int(words_to_limbs(pt))


def _plain_ints(words):
    """(..., 8) canonical plain words -> nested lists of python ints."""
    limbs = words_to_limbs(words).numpy()
    return [[limbs_to_int(v) for v in row] for row in limbs]


def _oracle(pairs):
    return JKzgAs.create_proof(None, pairs, JTranscriptPy())


@pytest.mark.parametrize("n", [1, 5])
def test_stacked_list_and_prover_folds_match_jax(n):
    pairs = _rand_pairs(n, seed=n)
    want = _oracle(pairs)
    stack = _stack(pairs)
    td = fold_transcript(1, "cpu")
    lhs, rhs = KzgAs.verify_stacked(stack[None], KzgAs.read_proof_stacked(False, stack[None], td))
    assert (_affine(lhs[0]), _affine(rhs[0])) == want
    lst = [(stack[None, i, 0], stack[None, i, 1]) for i in range(n)]
    td = fold_transcript(1, "cpu")
    lhs, rhs = KzgAs.verify(lst, KzgAs.read_proof(False, lst, td))
    assert (_affine(lhs[0]), _affine(rhs[0])) == want
    assert KzgAs.create_proof(None, pairs, PoseidonTranscriptPy()) == want


def test_prover_with_blind_matches_jax():
    pairs = _rand_pairs(3, seed=11)
    g, s_g = jpy_ec.G1_GEN, jpy_ec.scalar_mul(jpy_ec.G1_GEN, 12345)
    jt, t = JTranscriptPy(), PoseidonTranscriptPy()
    assert KzgAs.create_proof((g, s_g), pairs, t) == JKzgAs.create_proof((g, s_g), pairs, jt)
    assert t.streams() == jt.streams()
    # the verifier's side reads the blind pair from the prover's stream
    stack = _stack(pairs)[None]
    _, pts = t.streams()
    sc = torch.empty((1, 0, 8), dtype=torch.int32)
    ptw = limbs_to_words(from_affine_int(pts))[None, :, :2].contiguous()
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscript

    td = PoseidonTranscript(sc, ptw, "cpu")
    lhs, rhs = KzgAs.verify_stacked(stack, KzgAs.read_proof_stacked(True, stack, td))
    assert (_affine(lhs[0]), _affine(rhs[0])) == JKzgAs.create_proof((g, s_g), pairs,
                                                                      JTranscriptPy())


def _hierarchical_oracle(pairs, g):
    groups = [_oracle(pairs[i : i + g]) for i in range(0, len(pairs), g)]
    return _oracle(groups)


@pytest.mark.parametrize("n,g", [(64, 32), (35, 7)])
def test_fold_hierarchical_matches_jax_groups(n, g):
    assert KzgAs.group_size(n) == g
    pairs = _rand_pairs(n, seed=100 + n)
    lhs, rhs = KzgAs.fold_hierarchical(_stack(pairs))
    assert (_affine(lhs), _affine(rhs)) == _hierarchical_oracle(pairs, g)


def test_group_size_rule():
    assert [KzgAs.group_size(n) for n in (1, 2, 32, 33, 37, 64, 1024, 2048)] == [
        None, None, None, 11, None, 32, 32, 32]


def test_stacked_absorb_matches_jax_scan_and_oracle():
    rng = np.random.default_rng(3)
    pts = [jpy_ec.scalar_mul(jpy_ec.G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(3)]
    gold = PoseidonPy()
    gold.update([c for p in pts for c in p])
    want = gold.squeeze()

    def run(xy):
        t = JPoseidonTranscript()
        t.absorb_ec_points_scanned(xy)
        return t.squeeze_challenge()

    xy_j = jnp.stack([JFQ.from_int([p[0] for p in pts]), JFQ.from_int([p[1] for p in pts])], -2)
    assert int(JFR.to_int(jax.jit(run)(xy_j))) == want
    t = fold_transcript(1, "cpu")
    t.absorb_ec_points(limbs_to_words(from_affine_int(pts))[None, :, :2].contiguous())
    assert FRW.to_int(t.squeeze_challenge()).tolist() == [want]


@pytest.mark.parametrize("n", [1, 2, 33])
def test_powers_plain_matches_jax_powers_stack(n):
    rng = np.random.default_rng(n)
    rs = [int(rng.integers(1, 1 << 62)) * 7919 % FR.p for _ in range(2)]
    want = np.asarray(JFR.to_int(_powers_stack(JFR.from_int(rs), n))).T.tolist()  # (2, n)
    got = powers_plain(FRW.from_int(rs), n)
    assert [[int(v) for v in row] for row in want] == _plain_ints(got)
    assert torch.equal(powers(FRW.from_int(rs), n), got)
    assert [int(v) for v in want[0]] == [pow(rs[0], i, FR.p) for i in range(n)]


def test_powers_wrapper_refuses():
    r = FRW.from_int([5, 6])
    with pytest.raises(ValueError):
        powers(r, 0)
    with pytest.raises(ValueError):
        powers(torch.stack([r, r], -1)[..., 0], 3)  # not contiguous
    with pytest.raises(TypeError):
        powers(r.long(), 3)


def test_codec_matches_jax():
    pairs = _rand_pairs(1, seed=9)[0]
    limbs = acc.accumulator_to_limbs_int(pairs)
    assert limbs == jacc.accumulator_to_limbs_int(pairs)
    assert acc.accumulator_from_limbs_int(limbs) == pairs
    assert jacc.accumulator_from_limbs_int(limbs) == pairs
    # limbs above 88 bits are masked away, on the host and the device
    noisy = [v + (k + 1 << acc.BITS) for k, v in enumerate(limbs)]
    assert acc.accumulator_from_limbs_int(noisy) == pairs
    words = [FRW.from_int([v, w]) for v, w in zip(limbs, noisy)]
    lhs, rhs = acc.accumulator_from_limbs(words)
    assert [_affine(lhs[b]) for b in range(2)] == [pairs[0]] * 2
    assert [_affine(rhs[b]) for b in range(2)] == [pairs[1]] * 2
    jl, jr = jacc.accumulator_from_limbs([JFR.from_int(v) for v in noisy])
    assert FQW.to_int(lhs[1, :2]).tolist() == [int(v) for v in JFQ.to_int(jl[:2])]
    assert FQW.to_int(rhs[1, :2]).tolist() == [int(v) for v in JFQ.to_int(jr[:2])]
    with pytest.raises(ValueError):
        acc.accumulator_from_limbs(words[:11])


def test_identity_lane_folds_as_jax_device_path():
    """Lane 0 folds valid points, lane 1 the identity in every slot: the
    identity is absorbed as (0, 0) and contributes nothing to the sums."""
    pairs = _rand_pairs(2, seed=21)
    stack = torch.stack([_stack(pairs), _stack([(None, None)] * 2)], 0)  # (2, 2, 2, 3, 8)
    lhs, rhs = KzgAs._fold_once(stack)
    assert (_affine(lhs[0]), _affine(rhs[0])) == _oracle(pairs)
    assert _affine(lhs[1]) is None and _affine(rhs[1]) is None
    gold = PoseidonPy()
    gold.update([0] * 8)
    t = fold_transcript(2, "cpu")
    t.absorb_ec_points(torch.zeros((2, 4, 2, 8), dtype=torch.int32))
    assert FRW.to_int(t.squeeze_challenge()).tolist() == [gold.squeeze()] * 2
    with pytest.raises(errors.TranscriptError):
        PoseidonTranscriptPy().common_ec_point(None)  # the oracle's refusal stays
