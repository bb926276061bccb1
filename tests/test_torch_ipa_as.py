"""The port's IPA accumulation scheme (`pcs/ipa/ipa.py::IpaAs`) against the
JAX package's host prover (`IpaAs.create_proof`, as
tests/test_ipa.py::test_ipa_as_fold_roundtrip, N = 3 at k = 5), zk off and
on: the python-int `NATIVE` verifier and the recorded plan
(`batch_ipa_as_verify`) accept the fold and return the prover's ξ; a fold
whose accumulator U is replaced by another's rejects its lane alone; the
folded accumulator is decided true; the JAX package's device accumulators
and deciding key come across through `from_jax`.  The committed k = 11 folds
(`snark_verifier_tpu_torch/fixtures/ipa_as_k11.json`) verify natively.

Tolerance: exact (canonical words, python ints, accept bits)."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec.g1 import from_affine_int as j_from_affine_int
from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.pcs.ipa import Ipa as JIpa
from snark_verifier_tpu.pcs.ipa import IpaAccumulator as JIpaAccumulator
from snark_verifier_tpu.pcs.ipa import IpaDecidingKey as JIpaDecidingKey
from snark_verifier_tpu.pcs.ipa import IpaAs as JIpaAs
from snark_verifier_tpu.pcs.ipa import IpaProvingKey
from snark_verifier_tpu.transcript.poseidon_transcript import (
    PoseidonTranscriptPy as JPoseidonTranscriptPy,
)
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FR, FRW
from snark_verifier_tpu_torch.loader.base import NATIVE
from snark_verifier_tpu_torch.pcs.ipa import (
    IpaAccumulator,
    IpaAs,
    IpaDecidingKey,
    IpaFold,
    IpaSuccinctVerifyingKey,
    batch_ipa_as_verify,
    decide,
)
from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx
from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy

K = 5
R = FR.p


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _native(fold: IpaFold):
    proof = IpaAs.read_proof(fold.svk, fold.accs, PoseidonTranscriptPy(fold.scalars, fold.points),
                             NATIVE)
    return IpaAs.verify(fold.svk, fold.accs, proof, NATIVE)


@pytest.mark.parametrize("zk", [False, True])
def test_ipa_as_verifies_as_the_jax_prover_wrote(zk):
    rng = np.random.default_rng(13 + zk)
    pk = IpaProvingKey.rand(K, zk=zk, seed=14)
    accs = []
    for i in range(3):
        p = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(pk.n)]
        omega = int.from_bytes(rng.bytes(32), "little") % R if zk else None
        z = int.from_bytes(rng.bytes(32), "little") % R
        accs.append(JIpa.create_proof(pk, p, z, omega, JPoseidonTranscriptPy(), seed=20 + i))
    tr = JPoseidonTranscriptPy()
    folded = JIpaAs.create_proof(pk, accs, tr, seed=30)
    svk = IpaSuccinctVerifyingKey.from_jax(pk.svk())
    sc, pts = tr.streams()
    ours = [IpaAccumulator.from_jax(a) for a in accs]
    fold = IpaFold(svk, ours, sc, pts)
    bad = IpaFold(svk, ours[:2] + [IpaAccumulator(ours[2].xi, ours[0].u)], sc, pts)

    acc, ok = _native(fold)
    assert ok and acc.xi == folded.xi and acc.u == folded.u

    # the JAX package's device accumulators (16-bit Montgomery limbs, U
    # projective) and deciding key come across as the same values
    for a in accs[:2]:
        dev_acc = JIpaAccumulator([JFR.from_int(x) for x in a.xi], j_from_affine_int([a.u])[0])
        mine = IpaAccumulator.from_jax(dev_acc, device="cpu")
        assert [int(v) for v in FRW.to_int(mine.xi)] == a.xi
        assert to_affine_int(words_to_limbs(mine.u)) == a.u
    dk = IpaDecidingKey.from_jax(JIpaDecidingKey(pk.svk(), pk.g))
    assert dk.svk == svk and dk.g == list(pk.g)

    out, oks = batch_ipa_as_verify([fold, bad], device="cpu")
    assert oks.tolist() == [True, False]
    assert [int(v) for v in FRW.to_int(out.xi[0])] == folded.xi
    if not zk:
        assert bool(decide(IpaDecidingKey(svk, pk.g), out.lane(0)))


def test_committed_folds_verify_natively():
    folds, accs = fx.ipa_folds()
    assert [len(f.accs) for f in folds] == [16, 4] and [f.svk.zk for f in folds] == [0, 1]
    for fold, acc_p in zip(folds, accs):
        acc, ok = _native(fold)
        assert ok and acc.xi == acc_p.xi and acc.u == acc_p.u
