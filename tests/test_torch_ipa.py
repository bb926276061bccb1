"""The port's IPA PCS (`snark_verifier_tpu_torch.pcs.ipa`) against the JAX
package's, on proofs from the JAX package's host prover
(`Ipa.create_proof`, `IpaProvingKey.rand`) at k = 5:

  * `h_coeffs_plain` (the plain version of `svt_ipa_h_coeffs`; `h_coeffs` on
    a CPU tensor) and h(z) against the JAX package's `h_coeffs_dev` /
    `h_eval_dev`, run eagerly, and `h_coeffs_int` / `h_eval_int`, with
    distinct ξ (a bit-order slip shows only then) and the scalar factor;
  * `Ipa`, zk off and on, three ways -- the python-int `NATIVE` loader, the
    eager `TorchLoader` and the recorded plan (`batch_ipa_verify`) -- each
    accepting, each returning the prover's ξ (what the JAX package's
    verifier returns, tests/test_ipa.py:78-79), each rejecting an eval + 1;
  * `decide` of the plan's accumulator: U equals ⟨h(ξ), G⟩ by `py_ec.msm`,
    accepted, and U = H rejected;
  * a batch of two keys, or of two BGH19 query shapes, is refused;
  * the committed k = 11 fixtures (`snark_verifier_tpu_torch/fixtures/
    ipa_*.json`) against the JAX prover: the key and one opening remade
    and compared, the first opening accepted by the port's NATIVE verifier.

The JAX package's device IPA verify takes minutes to compile on XLA:CPU
(tests/test_ipa.py is `slow`), so tier-1 holds the port to the JAX host
prover and `PoseidonTranscriptPy`; the one test that runs JAX's
`Ipa.succinct_verify` beside the port is marked `slow`.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ipa.py

rewrites the fixtures (~2 minutes).

Tolerance: exact (canonical words, python ints, accept bits)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.pcs.ipa import Ipa as JIpa
from snark_verifier_tpu.pcs.ipa import IpaAs as JIpaAs
from snark_verifier_tpu.pcs.ipa import IpaProvingKey
from snark_verifier_tpu.pcs.ipa.ipa import h_coeffs_dev, h_eval_dev
from snark_verifier_tpu.transcript.poseidon_transcript import (
    PoseidonTranscriptPy as JPoseidonTranscriptPy,
)
from snark_verifier_tpu.utils.py_poly import peval
from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec
from snark_verifier_tpu_torch.ff import FR, FRW, limbs_to_int
from snark_verifier_tpu_torch.loader.base import NATIVE, TorchLoader
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.pcs.ipa import (
    Bgh19Opening,
    Ipa,
    IpaAccumulator,
    IpaDecidingKey,
    IpaOpening,
    IpaSuccinctVerifyingKey,
    batch_bgh19_verify,
    batch_ipa_verify,
    decide,
    h_coeffs_int,
    h_eval,
    h_eval_int,
)
from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx
from snark_verifier_tpu_torch.transcript import PoseidonTranscript, PoseidonTranscriptPy

K = 5
R = FR.p
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _limb_ints(limbs):
    return [limbs_to_int(r.numpy()) for r in limbs]


# ------------------------------------------------------------------ h(X)


def test_h_coeffs_and_h_eval_match_jax():
    rng = np.random.default_rng(11)
    xi, z, s = _rand(rng, K), _rand(rng, 1)[0], _rand(rng, 1)[0]
    assert len(set(xi)) == K
    want = h_coeffs_int(xi)
    # the JAX package's device coefficients, eagerly
    jc = h_coeffs_dev([JFR.from_int(x) for x in xi])
    assert [int(v) for v in JFR.to_int(jc)] == want
    xw = FRW.from_int(xi)
    assert _limb_ints(cuda_ops.h_coeffs_plain(xw)) == want
    assert _limb_ints(cuda_ops.h_coeffs(xw)) == want  # CPU: the plain version
    assert _limb_ints(cuda_ops.h_coeffs(xw, FRW.from_int(s))) == h_coeffs_int(xi, s)
    assert _limb_ints(cuda_ops.h_coeffs(FRW.from_int(xi[:1]))) == h_coeffs_int(xi[:1])
    assert _limb_ints(cuda_ops.h_coeffs(xw[:0])) == [1]
    # h(z): the JAX package's, the port's on both loaders, the host's
    jz = int(JFR.to_int(h_eval_dev([JFR.from_int(x) for x in xi], JFR.from_int(z))))
    assert jz == h_eval_int(xi, z) == h_eval(xi, z, NATIVE) == peval(want, z)
    L = TorchLoader(1, CPU)
    got = h_eval([FRW.from_int([x]) for x in xi], FRW.from_int([z]), L)
    assert int(FRW.to_int(got)[0]) == jz


# ------------------------------------------------------------- openings


def _opening(zk, seed, tamper=0):
    """A k = 5 opening from the JAX prover -> (svk, pk, IpaOpening, prover acc)."""
    rng = np.random.default_rng(seed)
    pk = IpaProvingKey.rand(K, zk=zk, seed=seed + 1)
    p = _rand(rng, pk.n)
    omega = _rand(rng, 1)[0] if zk else None
    c = pk.commit(p, omega)
    z = _rand(rng, 1)[0]
    tr = JPoseidonTranscriptPy()
    acc = JIpa.create_proof(pk, p, z, omega, tr, seed=seed + 2)
    svk = IpaSuccinctVerifyingKey.from_jax(pk.svk())
    sc, pts = tr.streams()
    return svk, pk, IpaOpening(svk, c, z, (peval(p, z) + tamper) % R, sc, pts), acc


@pytest.mark.parametrize("zk", [False, True])
def test_ipa_verifies_as_the_jax_prover_wrote(zk):
    svk, pk, op, acc_p = _opening(zk, 3 + 10 * zk)
    bad = IpaOpening(svk, op.c, op.z, (op.v + 1) % R, op.scalars, op.points)

    # NATIVE: accepts, the prover's xi; the tampered eval rejects
    for o, want in ((op, True), (bad, False)):
        proof = Ipa.read_proof(svk, PoseidonTranscriptPy(o.scalars, o.points))
        acc, ok = Ipa.succinct_verify(svk, NATIVE.msm_base(o.c), o.z, o.v, proof, NATIVE)
        assert ok is want and acc.xi == acc_p.xi and acc.u == acc_p.u

    # the recorded plan over a batch of [valid, tampered]
    accs, oks = batch_ipa_verify([op, bad], device="cpu")
    assert oks.tolist() == [True, False]
    for b in range(2):
        assert [int(v) for v in FRW.to_int(accs.xi[b])] == acc_p.xi

    if not zk:  # the eager TorchLoader witness on the same two lanes
        L = TorchLoader(2, CPU)
        sc = torch.from_numpy(np.stack([op.host[2]] * 2))
        pts = torch.from_numpy(np.stack([op.host[3]] * 2))
        proof = Ipa.read_proof(svk, PoseidonTranscript(sc, pts, CPU))
        cw = limbs_to_words(from_affine_int([op.c]))[0]
        acc, ok = Ipa.succinct_verify(svk, L.msm_base_proj(cw), FRW.from_int([op.z] * 2),
                                      FRW.from_int([op.v, bad.v]), proof, L)
        assert ok.tolist() == [True, False]
        assert [[int(v) for v in FRW.to_int(torch.stack([x[b] for x in acc.xi]))]
                for b in range(2)] == [acc_p.xi] * 2

    # the decider (~7 s a CPU call): U == <h(xi), G> by the python-int MSM;
    # the plan's accumulator accepted; U = H (as words) and -U (as host
    # ints) rejected
    assert py_ec.msm(pk.g, h_coeffs_int(acc_p.xi)) == acc_p.u
    dk = IpaDecidingKey(svk, pk.g)
    assert bool(decide(dk, accs.lane(0)))
    if zk:
        assert not bool(decide(dk, IpaAccumulator(acc_p.xi, py_ec.neg(acc_p.u)), "cpu"))
    else:
        assert not bool(decide(dk, IpaAccumulator(accs.xi[0], limbs_to_words(
            from_affine_int([pk.h]))[0])))


def test_batches_refuse_mixed_keys_and_shapes():
    """A batch verifies under one key and one proof shape, as
    `batch_succinct_verify` verifies one protocol: the plan lookup refuses
    the rest before any read."""
    svk, _, op, _ = _opening(False, 3)
    other = IpaSuccinctVerifyingKey(svk.k, svk.g0, py_ec.neg(svk.h))
    with pytest.raises(ValueError, match="one key"):
        batch_ipa_verify([op, IpaOpening(other, op.c, op.z, op.v, op.scalars, op.points)],
                         device="cpu")
    bigger = IpaSuccinctVerifyingKey(svk.k + 1, svk.g0, svk.h)
    with pytest.raises(ValueError, match="one key"):
        batch_ipa_verify([op, IpaOpening(bigger, op.c, op.z, op.v, op.scalars, op.points)],
                         device="cpu")
    q = [(0, 1, 5), (1, 1, 6)]
    a = Bgh19Opening(svk, [op.c, op.c], 3, q, op.scalars, op.points)
    b = Bgh19Opening(svk, [op.c, op.c], 3, q[:1] + [(1, 7, 6)], op.scalars, op.points)
    with pytest.raises(ValueError, match="one proof shape"):
        batch_bgh19_verify([a, b], device="cpu")


@pytest.mark.slow
def test_ipa_beside_the_jax_device_verifier():
    """JAX's jitted `Ipa.succinct_verify` (minutes to compile on XLA:CPU) and the
    port's plan on the same proof: the same bit and challenges."""
    from snark_verifier_tpu.ec.g1 import from_affine_int as j_from_affine_int
    from snark_verifier_tpu.loader.msm_expr import MsmExpr
    from snark_verifier_tpu.transcript.poseidon_transcript import PoseidonTranscript as JPT

    svk, pk, op, _ = _opening(False, 21)
    tr = JPT(scalars=jnp.stack([JFR.from_int(s) for s in op.scalars]),
             points=jnp.stack([j_from_affine_int([p])[0][:2] for p in op.points]))
    proof = JIpa.read_proof(pk.svk(), tr)
    jacc, jok = JIpa.succinct_verify(pk.svk(), MsmExpr.base(j_from_affine_int([op.c])[0]),
                                     JFR.from_int(op.z), JFR.from_int(op.v), proof)
    accs, oks = batch_ipa_verify([op], device="cpu")
    assert bool(jok) and oks.tolist() == [True]
    assert [int(v) for v in JFR.to_int(jnp.stack(jacc.xi))] == [
        int(v) for v in FRW.to_int(accs.xi[0])]


# ------------------------------------------------------------- fixtures


def _key_json(pk):
    return {"k": pk.k, "g": [fx.pt_hex(p) for p in pk.g], "h": fx.pt_hex(pk.h),
            "s": fx.pt_hex(pk.s)}


def _make_key():
    return IpaProvingKey.rand(fx.K, zk=True, seed=11)


def _plain_key(pk):
    return IpaProvingKey(pk.k, pk.g, pk.h, None)


def _make_opening(pk, zk, i):
    """Opening i of the fixtures: its JSON and the prover's accumulator."""
    rng = np.random.default_rng(1000 * zk + i)
    key = pk if zk else _plain_key(pk)
    p = _rand(rng, key.n)
    omega = _rand(rng, 1)[0] if zk else None
    c = key.commit(p, omega)
    z = _rand(rng, 1)[0]
    tr = JPoseidonTranscriptPy()
    acc = JIpa.create_proof(key, p, z, omega, tr, seed=2000 + 100 * zk + i)
    d = {"c": fx.pt_hex(c), "z": fx.fr_hex(z), "v": fx.fr_hex(peval(p, z)),
         **fx.streams_to_json(*tr.streams()), "acc": fx.acc_to_json(acc)}
    return d, acc


def _make_bgh19(pk, i):
    from snark_verifier_tpu.pcs.ipa.bgh19 import Bgh19 as JBgh19
    from snark_verifier_tpu.pcs.kzg.multiopen import Query as JQuery

    key = _plain_key(pk)
    rng = np.random.default_rng(3000 + i)
    polys = [_rand(rng, key.n) for _ in range(3)]
    x = _rand(rng, 1)[0]
    queries = [(0, 1, peval(polys[0], x)), (0, 7, peval(polys[0], 7 * x % R)),
               (1, 1, peval(polys[1], x)), (2, 1, peval(polys[2], x))]
    tr = JPoseidonTranscriptPy()
    acc = JBgh19.open(key, polys, [JQuery(*q) for q in queries], x, tr, seed=4000 + i)
    return {"commitments": [fx.pt_hex(key.commit(p)) for p in polys], "x": fx.fr_hex(x),
            "queries": [[p, sh, fx.fr_hex(ev)] for p, sh, ev in queries],
            **fx.streams_to_json(*tr.streams()), "acc": fx.acc_to_json(acc)}


def _make_fold(pk, zk, accs, seed):
    tr = JPoseidonTranscriptPy()
    acc = JIpaAs.create_proof(pk if zk else _plain_key(pk), accs, tr, seed=seed)
    return {"zk": int(zk), "accs": [fx.acc_to_json(a) for a in accs],
            **fx.streams_to_json(*tr.streams()), "acc": fx.acc_to_json(acc)}


def make_fixtures():
    """{file name: JSON} of every IPA fixture, from the JAX host provers."""
    pk = _make_key()
    openings = {zk: [_make_opening(pk, zk, i) for i in range(16)] for zk in (False, True)}
    return {
        f"ipa_key_k{fx.K}.json": _key_json(pk),
        f"ipa_openings_k{fx.K}.json": {"plain": [d for d, _ in openings[False]],
                                       "zk": [d for d, _ in openings[True]]},
        f"ipa_bgh19_k{fx.K}.json": {"openings": [_make_bgh19(pk, i) for i in range(4)]},
        f"ipa_as_k{fx.K}.json": {"folds": [
            _make_fold(pk, False, [a for _, a in openings[False]], 5000),
            _make_fold(pk, True, [a for _, a in openings[True][:4]], 5001)]},
    }


def test_committed_fixtures_are_the_host_provers():
    """The key and opening 0 (zk off and on) remade by the JAX prover equal
    the committed files; the port reads them back and its NATIVE verifier
    accepts opening 0 with the prover's xi."""
    pk = _make_key()
    on_disk = {name: json.loads((fx.FIXTURES / name).read_text()) for name in
               (f"ipa_key_k{fx.K}.json", f"ipa_openings_k{fx.K}.json")}
    assert on_disk[f"ipa_key_k{fx.K}.json"] == _key_json(pk)
    for zk, part in ((False, "plain"), (True, "zk")):
        d, _ = _make_opening(pk, zk, 0)
        assert on_disk[f"ipa_openings_k{fx.K}.json"][part][0] == d
        ops, accs = fx.ipa_openings(zk)
        op, svk = ops[0], ops[0].svk
        assert len(ops) == 16 and svk.zk == zk and svk.k == fx.K
        proof = Ipa.read_proof(svk, PoseidonTranscriptPy(op.scalars, op.points))
        acc, ok = Ipa.succinct_verify(svk, NATIVE.msm_base(op.c), op.z, op.v, proof, NATIVE)
        assert ok and acc.xi == accs[0].xi and acc.u == accs[0].u


if __name__ == "__main__":
    fx.FIXTURES.mkdir(exist_ok=True)
    for name, data in make_fixtures().items():
        (fx.FIXTURES / name).write_text(json.dumps(data, separators=(",", ":")))
        print(name, (fx.FIXTURES / name).stat().st_size, "bytes")
