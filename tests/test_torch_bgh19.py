"""The port's BGH19 multiopen (`pcs/ipa/bgh19.py`) against the JAX
package's host prover (`Bgh19.open`, the shape of tests/test_bgh19.py: 3
polynomials at k = 5, polynomial 0 opened at x and 7x, all at x, so two
query sets): the python-int `NATIVE` verifier and the recorded plan
(`batch_bgh19_verify`) accept it and return the prover's ξ, a tampered
query evaluation rejects its lane alone, and the plan's accumulator is
decided true.  The committed k = 11 multiopens
(`snark_verifier_tpu_torch/fixtures/ipa_bgh19_k11.json`) verify natively
with their prover's ξ.

Tolerance: exact (canonical words, python ints, accept bits)."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.pcs.ipa import IpaProvingKey
from snark_verifier_tpu.pcs.ipa.bgh19 import Bgh19 as JBgh19
from snark_verifier_tpu.pcs.kzg.multiopen import Query as JQuery
from snark_verifier_tpu.transcript.poseidon_transcript import (
    PoseidonTranscriptPy as JPoseidonTranscriptPy,
)
from snark_verifier_tpu.utils.py_poly import peval
from snark_verifier_tpu_torch.ff import FR, FRW
from snark_verifier_tpu_torch.loader.base import NATIVE
from snark_verifier_tpu_torch.pcs.ipa import (
    Bgh19,
    Bgh19Opening,
    IpaDecidingKey,
    IpaSuccinctVerifyingKey,
    batch_bgh19_verify,
    decide,
)
from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Query
from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy

K = 5
R = FR.p


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _native(op: Bgh19Opening):
    """The port's python-int BGH19 verify of one opening -> (acc, ok)."""
    queries = [Query(p, sh, ev) for p, sh, ev in op.queries]
    proof = Bgh19.read_proof(op.svk, queries, PoseidonTranscriptPy(op.scalars, op.points))
    return Bgh19.verify(op.svk, [NATIVE.msm_base(c) for c in op.commitments], op.x, queries,
                        proof, NATIVE)


def test_bgh19_verifies_as_the_jax_prover_wrote():
    rng = np.random.default_rng(41)
    pk = IpaProvingKey.rand(K, zk=False, seed=42)
    polys = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(pk.n)]
             for _ in range(3)]
    x = int.from_bytes(rng.bytes(32), "little") % R
    q = [(0, 1, peval(polys[0], x)), (0, 7, peval(polys[0], 7 * x % R)),
         (1, 1, peval(polys[1], x)), (2, 1, peval(polys[2], x))]
    tr = JPoseidonTranscriptPy()
    acc_p = JBgh19.open(pk, polys, [JQuery(*t) for t in q], x, tr, seed=43)
    svk = IpaSuccinctVerifyingKey.from_jax(pk.svk())
    sc, pts = tr.streams()
    comms = [pk.commit(p) for p in polys]
    op = Bgh19Opening(svk, comms, x, q, sc, pts)
    bad = Bgh19Opening(svk, comms, x, [q[0], q[1], (1, 1, (q[2][2] + 1) % R), q[3]], sc, pts)

    for o, want in ((op, True), (bad, False)):
        acc, ok = _native(o)
        assert ok is want and acc.xi == acc_p.xi and acc.u == acc_p.u

    accs, oks = batch_bgh19_verify([op, bad, op], device="cpu")
    assert oks.tolist() == [True, False, True]
    for b in range(3):
        assert [int(v) for v in FRW.to_int(accs.xi[b])] == acc_p.xi
    assert bool(decide(IpaDecidingKey(svk, pk.g), accs.lane(0)))


def test_committed_bgh19_fixtures_verify_natively():
    ops, accs = fx.bgh19_openings()
    assert len(ops) == 4 and ops[0].svk.k == fx.K and not ops[0].svk.zk
    for op, acc_p in zip(ops[:2], accs):
        acc, ok = _native(op)
        assert ok and acc.xi == acc_p.xi and acc.u == acc_p.u
