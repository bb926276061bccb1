"""The port's keccak (EVM) transcript against the JAX package's.

* `EvmTranscript` on the CPU (each squeeze `squeeze_plain`) against the JAX
  device `EvmTranscript` and the python-int `EvmTranscriptPy`, on the
  absorb/squeeze pattern of tests/test_keccak_device.py (a scalar, a point,
  a scalar, squeeze; a scalar, squeeze; a squeeze of the bare hash), at
  B = 2 and B = 16, with lazy Montgomery words (value + p) and a (8,)
  constant handle broadcast to the batch, as the protocol's initial state
  is absorbed.
* `parallel.batch_verify(device="cpu", transcript="evm")` on four
  `evmsnark` fixture lanes (a proof scalar + 1, an instance + 1, two valid)
  against the JAX package's `verify_snark_native(..., transcript="evm")`
  lane by lane, and the succinct accumulators against its
  `succinct_verify_native` after affine normalisation.
* A GWC19 proof made with the keccak transcript by the JAX package's host
  prover (StandardPlonk, k = 3, toy_srs(32)) accepted, and its tampered
  copy rejected, as the JAX package decides them.

Tolerance: exact (Montgomery words, affine ints, accept bits)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import from_affine_int as j_from_affine_int
from snark_verifier_tpu.ec import py_ec as jpy_ec
from snark_verifier_tpu.ff import FR_FIELD as J_FR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, prove
from snark_verifier_tpu.transcript import EvmTranscript as JEvmTranscript
from snark_verifier_tpu.transcript import EvmTranscriptPy as JEvmTranscriptPy
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native as j_verify
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FQ, FR, FRW, limbs_to_words
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params, toy_srs
from snark_verifier_tpu_torch.transcript import EvmTranscript, EvmTranscriptPy
from snark_verifier_tpu_torch.verifier.plonk.verifier import succinct_verify_native

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
INIT = 0x1234567890ABCDEF  # a constant absorbed first, as an initial state is


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lazy_limbs(vals, p, lift):
    """Montgomery limbs (numpy uint32 (n, 16)) of vals; where `lift`, the
    value + p, which the lazy [0, 2p] contract allows."""
    R = 1 << 256
    out = []
    for v, up in zip(vals, lift):
        m = v % p * R % p + (p if up else 0)
        out.append([(m >> (16 * i)) & 0xFFFF for i in range(16)])
    return np.array(out, np.uint32)


def _pattern(B):
    """The inputs: three scalars and one point per lane (Montgomery limbs),
    and the python-int oracle's three challenges per lane."""
    rng = np.random.default_rng(B)
    scal = [[int(rng.integers(1, 2**62)) * 7 + b for b in range(B)] for _ in range(3)]
    scal[1][0] = FR.p - 1
    pts = [jpy_ec.scalar_mul(jpy_ec.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(B)]
    lift = [b % 2 == 1 for b in range(B)]
    limbs = [_lazy_limbs(s, FR.p, lift) for s in scal]
    xy = np.asarray(j_from_affine_int(pts))[:, :2, :].copy()
    for b in range(B):
        if lift[b]:
            xy[b] = _lazy_limbs([pts[b][0], pts[b][1]], FQ.p, [True, True])
    want = []
    for b in range(B):
        t = JEvmTranscriptPy()
        t.common_scalar(INIT)
        t.common_scalar(scal[0][b])
        t.common_ec_point(pts[b])
        t.common_scalar(scal[1][b])
        c1 = t.squeeze_challenge()
        t.common_scalar(scal[2][b])
        want.append((c1, t.squeeze_challenge(), t.squeeze_challenge()))
    return limbs, xy, pts, scal, want


def _jax_run(B, limbs, xy):
    def run(init, s0, s1, s2, pt):
        t = JEvmTranscript(batch_shape=(B,))
        t.common_scalar(init)
        t.common_scalar(s0)
        t.common_ec_point(pt)
        t.common_scalar(s1)
        c1 = t.squeeze_challenge()
        t.common_scalar(s2)
        return c1, t.squeeze_challenge(), t.squeeze_challenge()

    init = J_FR.from_int(INIT)
    out = jax.jit(run)(init, *(jnp.asarray(l) for l in limbs), jnp.asarray(xy))
    return [np.asarray(c) for c in out]


@pytest.mark.parametrize("B", [2, 16])
def test_transcript_matches_jax_and_oracle(B):
    limbs, xy, pts, scal, want = _pattern(B)
    words = [limbs_to_words(torch.from_numpy(l.astype(np.int64))) for l in limbs]
    pt_words = limbs_to_words(torch.from_numpy(xy.astype(np.int64)))
    sc = torch.stack(words, 1)  # (B, 3, 8): the stream, read in order
    t = EvmTranscript(sc, pt_words[:, None], "cpu")
    t.common_scalar(FRW.scalar(INIT, "cpu"))  # a (8,) handle
    t.read_scalar()
    t.read_ec_point()
    t.read_scalar()
    c1 = t.squeeze_challenge()
    t.read_scalar()
    got = [c1, t.squeeze_challenge(), t.squeeze_challenge()]
    jax_got = _jax_run(B, limbs, xy)
    for g, j in zip(got, jax_got):
        assert torch.equal(g, limbs_to_words(torch.from_numpy(j.astype(np.int64))))
    for k in range(3):
        assert list(FRW.to_int(got[k])) == [w[k] for w in want]
    # the port's oracle is the JAX package's
    for b in range(B):
        t = EvmTranscriptPy()
        t.common_scalar(INIT)
        t.common_scalar(scal[0][b])
        t.common_ec_point(pts[b])
        t.common_scalar(scal[1][b])
        c1 = t.squeeze_challenge()
        t.common_scalar(scal[2][b])
        assert (c1, t.squeeze_challenge(), t.squeeze_challenge()) == want[b]
    # the challenges are in the lazy [0, 2r] contract
    for g in got:
        for row in g:
            assert sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row)) < 2 * FR.p


def test_oracle_refuses_identity():
    from snark_verifier_tpu_torch import errors

    with pytest.raises(errors.TranscriptError):
        EvmTranscriptPy().common_ec_point(None)


# ------------------------------------------------------- the verify path


def _four_lanes(snark_cls, base):
    """[a proof scalar + 1, an instance + 1, two valid proofs]."""
    s0, s1, s2, s3 = base
    bad_scalar = snark_cls(s0.protocol, [list(c) for c in s0.instances],
                           [(s0.scalars[0] + 1) % FR.p] + list(s0.scalars[1:]), s0.points)
    bad_inst = snark_cls(s1.protocol, [list(c) for c in s1.instances], s1.scalars, s1.points)
    bad_inst.instances[0][0] = (bad_inst.instances[0][0] + 1) % FR.p
    return [bad_scalar, bad_inst, s2, s3]


@pytest.fixture(scope="module")
def evm_lanes():
    names = [FIXTURES / f"evmsnark_{i:02d}.json" for i in range(4)]
    ours = _four_lanes(Snark, [Snark.load(str(n)) for n in names])
    theirs = _four_lanes(JSnark, [JSnark.load(str(n)) for n in names])
    return (load_params(str(FIXTURES / "srs.bin")), ours,
            j_load_params(str(FIXTURES / "srs.bin")), theirs)


def test_evm_batch_verify_matches_jax_native(evm_lanes):
    srs, ours, j_srs, theirs = evm_lanes
    want = [j_verify(s, j_srs, "shplonk", transcript="evm") for s in theirs]
    assert want == [False, False, True, True]
    assert batch_verify(ours, srs, "shplonk", "evm", device="cpu").tolist() == want
    # read through Poseidon, a keccak proof does not verify
    assert batch_verify(ours[2:], srs, "shplonk", "poseidon", device="cpu").tolist() == [False] * 2


def test_evm_accumulators_match_jax_native(evm_lanes):
    srs, ours, j_srs, theirs = evm_lanes
    ((lhs, rhs),) = batch_succinct_verify(ours, srs, "shplonk", "evm", device="cpu")
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    want = [j_native(s, j_srs, "shplonk", "evm")[0] for s in theirs]
    assert got == want
    assert [succinct_verify_native(s, srs, "shplonk", "evm")[0] for s in ours] == want
    assert len(set(want)) == 4


@pytest.fixture(scope="module")
def gwc_keccak():
    """A GWC19 proof made with the keccak transcript (k = 3, toy_srs(32)),
    and a copy with its instance moved by one, in both packages."""
    srs_j = j_toy_srs(32)
    circ = StandardPlonk.rand(k=3, seed=21)
    protocol = build_protocol(circ, srs_j)
    scalars, points = prove(circ, protocol, srs_j, scheme="gwc", transcript=JEvmTranscriptPy())
    good = JSnark(protocol, [list(circ.instance)], scalars, points)
    bad = JSnark(protocol, [[(circ.instance[0] + 1) % FR.p]], scalars, points)
    return srs_j, [good, bad], toy_srs(32), [Snark.from_json(s.to_json()) for s in (good, bad)]


def test_gwc_keccak_proof_matches_jax(gwc_keccak):
    srs_j, theirs, srs, ours = gwc_keccak
    want = [j_verify(s, srs_j, "gwc", transcript="evm") for s in theirs]
    assert want == [True, False]
    assert not j_verify(theirs[0], srs_j, "gwc", transcript="poseidon")
    assert batch_verify(ours, srs, "gwc", "evm", device="cpu").tolist() == want
    assert ([succinct_verify_native(s, srs, "gwc", "evm") for s in ours]
            == [j_native(s, srs_j, "gwc", "evm") for s in theirs])
