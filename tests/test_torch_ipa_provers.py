"""The port's IPA host provers (`pcs/ipa/ipa.py`: `IpaProvingKey`,
`Ipa.create_proof`, `IpaAs.create_proof`; `pcs/ipa/bgh19.py`:
`Bgh19.open`) against the JAX package's at k = 5, every MSM on the CPU
(`device="cpu"`), as tests/test_torch_ipa.py makes its proofs:

  * `IpaProvingKey.rand` (with and without zk) gives the JAX package's
    bases, `commit` (with ω and S, and without) its points, `svk` its key;
  * `Ipa.create_proof`, without and with zk: the streams, ξ and U equal
    the JAX package's, and the port's python-int verifier (`Ipa.
    succinct_verify` under `NATIVE`) accepts them;
  * `IpaAs.create_proof` over three of those accumulators (without and
    with zk) and `Bgh19.open` (queries at x and 7x): the streams and the
    accumulator equal the JAX package's;
  * `IpaAs` refuses to fold one accumulator.

Tolerance: exact (python ints)."""

import numpy as np
import pytest

from snark_verifier_tpu.pcs.ipa import Ipa as JIpa
from snark_verifier_tpu.pcs.ipa import IpaAs as JIpaAs
from snark_verifier_tpu.pcs.ipa import IpaProvingKey as JKey
from snark_verifier_tpu.pcs.ipa.bgh19 import Bgh19 as JBgh19
from snark_verifier_tpu.pcs.kzg.multiopen import Query as JQuery
from snark_verifier_tpu.transcript.poseidon_transcript import PoseidonTranscriptPy as JPos
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.loader.base import NATIVE
from snark_verifier_tpu_torch.pcs.ipa import Bgh19, Ipa, IpaAs, IpaProvingKey
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Query
from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy
from snark_verifier_tpu_torch.utils.py_poly import peval

K = 5
R = FR.p


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


@pytest.fixture(scope="module")
def keys():
    pk, jpk = IpaProvingKey.rand(K, zk=True, seed=3), JKey.rand(K, zk=True, seed=3)
    return {True: (pk, jpk), False: (IpaProvingKey(K, pk.g, pk.h), JKey(K, jpk.g, jpk.h))}


def test_key_matches_jax(keys):
    pk, jpk = keys[True]
    assert (pk.g, pk.h, pk.s) == (jpk.g, jpk.h, jpk.s)
    plain = IpaProvingKey.rand(K, seed=3)
    assert plain.s is None and plain.g == pk.g and plain.h == pk.h
    assert vars(pk.svk()) == vars(jpk.svk())
    rng = np.random.default_rng(1)
    p, omega = _rand(rng, 20), _rand(rng, 1)[0]
    assert pk.commit(p, omega, device="cpu") == jpk.commit(p, omega)
    assert pk.commit(p, device="cpu") == jpk.commit(p)
    assert pk.commit([0, 0], device="cpu") is None


def _opening(keys, zk, i):
    pk, jpk = keys[zk]
    rng = np.random.default_rng(100 * zk + i)
    p = _rand(rng, pk.n)
    omega = _rand(rng, 1)[0] if zk else None
    z = _rand(rng, 1)[0]
    t, jt = PoseidonTranscriptPy(), JPos()
    acc = Ipa.create_proof(pk, p, z, omega, t, seed=10 + i, device="cpu")
    jacc = JIpa.create_proof(jpk, p, z, omega, jt, seed=10 + i)
    return p, omega, z, t, jt, acc, jacc


@pytest.mark.parametrize("zk", [False, True])
def test_ipa_proof_matches_jax_and_verifies(keys, zk):
    pk, _ = keys[zk]
    p, omega, z, t, jt, acc, jacc = _opening(keys, zk, 0)
    assert t.streams() == jt.streams()
    assert (acc.xi, acc.u) == (jacc.xi, jacc.u)
    svk = pk.svk()
    proof = Ipa.read_proof(svk, PoseidonTranscriptPy(*t.streams()))
    c = NATIVE.msm_base(pk.commit(p, omega, device="cpu"))
    got, ok = Ipa.succinct_verify(svk, c, z, peval(p, z), proof, NATIVE)
    assert ok and got.xi == acc.xi and got.u == acc.u


@pytest.mark.parametrize("zk", [False, True])
def test_ipa_as_matches_jax(keys, zk):
    pk, jpk = keys[zk]
    openings = [_opening(keys, zk, i) for i in range(3)]
    t, jt = PoseidonTranscriptPy(), JPos()
    acc = IpaAs.create_proof(pk, [o[5] for o in openings], t, seed=5, device="cpu")
    jacc = JIpaAs.create_proof(jpk, [o[6] for o in openings], jt, seed=5)
    assert t.streams() == jt.streams()
    assert (acc.xi, acc.u) == (jacc.xi, jacc.u)
    with pytest.raises(ValueError):
        IpaAs.create_proof(pk, [openings[0][5]], PoseidonTranscriptPy(), device="cpu")


def test_bgh19_open_matches_jax(keys):
    pk, jpk = keys[False]
    rng = np.random.default_rng(9)
    polys = [_rand(rng, pk.n) for _ in range(3)]
    x = _rand(rng, 1)[0]
    queries = [(0, 1, peval(polys[0], x)), (0, 7, peval(polys[0], 7 * x % R)),
               (1, 1, peval(polys[1], x)), (2, 1, peval(polys[2], x))]
    t, jt = PoseidonTranscriptPy(), JPos()
    acc = Bgh19.open(pk, polys, [Query(*q) for q in queries], x, t, seed=4, device="cpu")
    jacc = JBgh19.open(jpk, polys, [JQuery(*q) for q in queries], x, jt, seed=4)
    assert t.streams() == jt.streams()
    assert (acc.xi, acc.u) == (jacc.xi, jacc.u)
