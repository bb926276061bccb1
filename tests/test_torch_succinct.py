"""Port batched succinct verifier (sdk/aggregation.py::batch_succinct_verify
on device="cpu", i.e. every kernel's plain twin) and its python-int oracle
vs the JAX package's succinct_verify_native, on the committed vanilla-PLONK
k=10 fixtures (SHPLONK, Poseidon transcript); and the port's host loaders
(Snark.load, host_streams, load_params) vs the JAX package's.

Tolerance: exact.  Accumulators compare as affine ints."""

from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ff import FR as JFR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import np_limbs_to_words
from snark_verifier_tpu_torch.pairing.py_pairing import g2_is_on_curve
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
NAMES = [f"snark_{i:02d}.json" for i in range(16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def srs_pair():
    return load_params(str(FIXTURES / "srs.bin")), j_load_params(str(FIXTURES / "srs.bin"))


def _tampered(snark_cls, s):
    t = snark_cls(s.protocol, [list(c) for c in s.instances], s.scalars, s.points)
    t.instances[0][0] = (t.instances[0][0] + 1) % JFR.p
    return t


@pytest.fixture(scope="module")
def batch_run(srs_pair):
    """One CPU batch of three lanes: fixtures 0 and 1 and fixture 0 with its
    first instance moved by one."""
    srs, _ = srs_pair
    snarks = [Snark.load(str(FIXTURES / n)) for n in NAMES[:2]]
    snarks.append(_tampered(Snark, snarks[0]))
    accs = batch_succinct_verify(snarks, srs, device="cpu")
    return [[(a, b) for a, b in zip(to_affine_int(words_to_limbs(lhs)),
                                    to_affine_int(words_to_limbs(rhs)))] for lhs, rhs in accs]


def _jax_native(i, srs_j, tamper=False):
    s = JSnark.load(str(FIXTURES / NAMES[i]))
    return j_native(_tampered(JSnark, s) if tamper else s, srs_j)


@pytest.mark.parametrize("lane", [0, 1])
def test_batch_cpu_matches_jax_native(batch_run, srs_pair, lane):
    (acc,) = j_native_list = _jax_native(lane, srs_pair[1])
    assert len(batch_run) == len(j_native_list) == 1
    assert batch_run[0][lane] == acc
    assert None not in acc


def test_tampered_instance_moves_only_its_lane(batch_run, srs_pair):
    (want,) = _jax_native(0, srs_pair[1], tamper=True)
    lanes = batch_run[0]
    assert lanes[2] == want
    assert lanes[2] != lanes[0]
    assert lanes[0] == _jax_native(0, srs_pair[1])[0]


def test_native_oracle_matches_jax_native(srs_pair):
    srs, srs_j = srs_pair
    s = Snark.load(str(FIXTURES / NAMES[5]))
    assert succinct_verify_native(s, srs) == _jax_native(5, srs_j)
    assert succinct_verify_native(_tampered(Snark, s), srs) == _jax_native(5, srs_j, tamper=True)


def test_host_loaders_match_jax(srs_pair):
    srs, srs_j = srs_pair
    assert srs.g1_powers == srs_j.g1_powers
    assert srs.g_lagrange == srs_j.g_lagrange()
    assert (srs.g2, srs.s_g2) == (srs_j.g2, srs_j.s_g2)
    assert g2_is_on_curve(srs.g2) and g2_is_on_curve(srs.s_g2)
    assert torch.equal(srs.g_dev("cpu"), torch.from_numpy(np_limbs_to_words(np.asarray(srs_j.g_dev))))
    for name in NAMES:
        ours, theirs = Snark.load(str(FIXTURES / name)), JSnark.load(str(FIXTURES / name))
        assert ours.protocol.to_json() == theirs.protocol.to_json()
        assert ours.protocol.content_hash() == theirs.protocol.content_hash()
        assert (ours.instances, ours.scalars, ours.points) == (
            theirs.instances, theirs.scalars, theirs.points)
        sc, pts = ours.host_streams()
        jsc, jpts = theirs.host_streams()
        assert np.array_equal(sc, np_limbs_to_words(jsc))
        assert np.array_equal(pts, np_limbs_to_words(jpts))


def test_rejects_unsupported_and_malformed_input(srs_pair):
    srs, _ = srs_pair
    s = Snark.load(str(FIXTURES / NAMES[0]))
    for scheme, transcript in (("kzg", "poseidon"), ("shplonk", "blake2b"), ("gwc", "blake2b")):
        with pytest.raises(ValueError):
            batch_succinct_verify([s], srs, scheme, transcript, device="cpu")
    with pytest.raises(ValueError):
        batch_succinct_verify([], srs, device="cpu")
    bad = Snark(s.protocol, s.instances, s.scalars, [(1, 3)] + s.points[1:])
    with pytest.raises(errors.TranscriptError):
        bad.host_streams()
    short = Snark(s.protocol, [[]], s.scalars, s.points)
    with pytest.raises(errors.InvalidInstances):
        short.validate()
