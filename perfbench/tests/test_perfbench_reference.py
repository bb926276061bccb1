"""The plain reference against the pool's known verdicts (honest proofs
accepted, a tampered instance, proof scalar or proof point
rejected), against a second witness (the port's python-int oracle and its
python-int pairing), and the MSM cell's bases, sums and output codec
against python ints."""

import json
import random

import pytest
import torch

import reference
from harness import codec, g1_torch
from harness import traffic as tr
from harness.catalog import BENCH_DIR
from harness.entries import msm_commit
from harness.entries._proofs import _ints
from reference import py_ec
from reference.fields import FQ, FR
from reference.protocol import PlonkProtocol as RefProtocol

FIX = BENCH_DIR / "fixtures"
CONFIG = json.loads((BENCH_DIR / "configs" / "sdk-standard-plonk-k8.json").read_text())
POOLS = CONFIG["fixtures"]["pools"]
SRS = FIX / CONFIG["srs"]["file"]


def _protocol():
    return RefProtocol.from_json(json.loads((FIX / CONFIG["fixtures"]["protocol"]).read_text()))


def _pool_rows(transcript, picks):
    with open(FIX / POOLS[transcript]) as f:
        lines = f.readlines()
    assert len(lines) == CONFIG["fixtures"]["count"]
    return [_ints(json.loads(lines[i])) for i in picks]


@pytest.fixture(scope="module")
def srs():
    return reference.ToySrs.load(SRS, 0xA11CE)


@pytest.mark.parametrize("transcript", ["poseidon", "evm"])
def test_honest_pool_proofs_are_accepted(srs, transcript):
    proto = _protocol()
    picks = random.Random(transcript).sample(range(CONFIG["fixtures"]["count"]), 6)
    for i, row in zip(picks, _pool_rows(transcript, picks)):
        assert reference.verdict(reference.Snark(proto, *row), srs, "shplonk", transcript), i


@pytest.mark.parametrize("kind", ["instance", "scalar", "point"])
@pytest.mark.parametrize("transcript", ["poseidon", "evm"])
def test_a_tampered_proof_is_rejected_and_the_control_accepts_it(srs, kind, transcript):
    row, = _pool_rows(transcript, [3])
    t = tr.Tamper(3, kind, 5, 12345)
    bad = reference.Snark(_protocol(), *t.apply(*row))
    assert not reference.verdict(bad, srs, "shplonk", transcript)
    assert reference.verdict(bad, srs, "shplonk", transcript, decide=False)


def test_the_pool_proves_the_sdk_circuit():
    """The protocol is StandardPlonk's shape: 5 fixed and 3 sigma
    commitments, one instance, 3 advice, 3 permutation z-polys, the random
    polynomial, 2 quotient pieces and SHPLONK's 2 points a proof; the
    instances of the pool all differ."""
    proto = _protocol()
    assert len(proto.preprocessed) == 8 and proto.num_instance == [1]
    assert proto.domain.k == CONFIG["circuit"]["k"] == 8
    rows = _pool_rows("poseidon", range(CONFIG["fixtures"]["count"]))
    assert {len(r[2]) for r in rows} == {3 + 3 + 1 + 2 + 2}
    assert len({r[0][0][0] for r in rows}) == len(rows)
    assert all(r[0][0][0] < 1 << 32 for r in rows)


def test_the_trapdoor_decide_agrees_with_the_pairing(srs):
    """Second witness: the port's python-int pairing on the SRS the port
    loads itself, on an honest and a tampered accumulator."""
    from snark_verifier_tpu_torch.pairing import py_pairing as pp
    from snark_verifier_tpu_torch.sdk.srs import load_params

    psrs = load_params(str(SRS))
    assert pp.g2_scalar_mul(psrs.g2, srs.tau) == psrs.s_g2
    row, = _pool_rows("poseidon", [7])
    (lhs, rhs), = reference.succinct_verify(reference.Snark(_protocol(), *row), srs.g)
    neg = pp.g2_neg(psrs.s_g2)
    for l, r in [(lhs, rhs), (py_ec.add(lhs, py_ec.G1_GEN), rhs)]:
        assert srs.decide(l, r) == pp.pairing_check([(l, psrs.g2), (r, neg)])


def test_the_reference_agrees_with_the_ports_host_oracle(srs):
    """Second witness: the port's own python-int oracle reads the same
    accumulators and folds them the same way."""
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.sdk.snark import Snark as PSnark
    from snark_verifier_tpu_torch.sdk.srs import load_params
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv
    from snark_verifier_tpu_torch.verifier.plonk.protocol import PlonkProtocol

    psrs = load_params(str(SRS))
    pproto = PlonkProtocol.from_json(json.loads((FIX / CONFIG["fixtures"]["protocol"]).read_text()))
    accs = []
    for tx in ("poseidon", "evm"):
        for row in _pool_rows(tx, [0, 1]):
            mine = reference.succinct_verify(reference.Snark(_protocol(), *row), srs.g,
                                             "shplonk", tx)
            assert mine == pv.succinct_verify_native(PSnark(pproto, *row), psrs, "shplonk", tx)
            accs += mine
    for n in (1, 2, 4):
        assert reference.fold(accs[:n]) == KzgAs.create_proof(None, accs[:n], PoseidonTranscriptPy())
    for n in (1, 2, 31, 32, 33, 64, 96, 1024, 1026):
        assert reference.accumulation.group_size(n) == KzgAs.group_size(n)


def test_field_and_point_arithmetic_in_plain_torch():
    rng = random.Random(1)
    xs = [rng.randrange(FQ.p) for _ in range(40)] + [0, 1, FQ.p - 1]
    ys = [rng.randrange(FQ.p) for _ in range(40)] + [FQ.p - 1, 0, FQ.p - 1]
    a, b = g1_torch.to_mont_limbs(xs, "cpu"), g1_torch.to_mont_limbs(ys, "cpu")
    for fn, ref in [(g1_torch.mont_mul, lambda x, y: x * y), (g1_torch.add, lambda x, y: x + y),
                    (g1_torch.sub, lambda x, y: x - y)]:
        out = fn(a, b)
        assert [g1_torch.from_mont_int(r.tolist()) for r in out] == [ref(x, y) % FQ.p
                                                                     for x, y in zip(xs, ys)]
        assert all(g1_torch.limbs_to_int(r.tolist()) < FQ.p for r in out)
        assert int(out.min()) >= 0 and int(out.max()) <= 0xFFFF


def test_msm_bases_scalars_and_reference_sum():
    n = 4096
    a, d = tr.msm_base_params(2**31 + 7, n)
    bases = msm_commit.make_bases(n, a, d, "cpu", chunk=1000)
    for i in (0, 1, 2047, 2048, 2049, 4095):
        want = py_ec.scalar_mul(py_ec.G1_GEN, (a + (i + 2048) * d) % FR.p)
        assert codec.affine(bases[i].numpy(), 16) == want
    sc = msm_commit.make_scalars(n, 2, tr.msm_scalar_seed(5), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(sc, msm_commit.make_scalars(n, 2, tr.msm_scalar_seed(5), "cpu")))
    ints = [sum(int(v) << (16 * j) for j, v in enumerate(row)) for row in sc[1].tolist()]
    assert all(0 <= v < FR.p for v in ints) and max(ints) > FR.p // 2
    k = lambda i: (a + (i + 2048) * d) % FR.p
    assert msm_commit.reference_sum(sc[1], a, d) == sum(v * k(i) for i, v in enumerate(ints)) % FR.p
    assert msm_commit.reference_sum(sc[1], a, d, True) == \
        sum((v >> 16 << 16) * k(i) for i, v in enumerate(ints)) % FR.p
    # the sum is Σ sᵢ·Bᵢ: a python-int MSM over the first 64 bases
    pts = [codec.affine(bases[i].numpy(), 16) for i in range(64)]
    part = py_ec.msm(pts, ints[:64])
    assert part == py_ec.scalar_mul(py_ec.G1_GEN, sum(v * k(i) for i, v in enumerate(ints[:64])) % FR.p)


def test_codec_round_trip():
    for pt in (None, py_ec.G1_GEN, py_ec.scalar_mul(py_ec.G1_GEN, 987654321)):
        assert codec.affine(codec.encode(pt, 32), 32) == pt
        assert codec.affine(codec.encode(pt, 16), 16) == pt


def test_traffic_is_the_same_for_a_seed_and_keeps_its_sizes():
    p = {"lanes": 1024, "batches": 4, "tampered_batches": 4, "tampers_per_batch": 16,
         "tamper_variants": 16}
    a, b, c = (tr.proof_lanes(p, s, 1024) for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert a == b and a != c
    for x in (a, c):
        assert [len(bt) for bt in x.batches] == [1024] * 4
        # no proof twice in a batch the pool fills: 1,008 honest lanes, all distinct
        assert all(len({f for f, t in bt if t is None}) == 1024 - 16 for bt in x.batches)
        tam = [lane for bt in x.batches for lane in bt if lane[1] is not None]
        assert len(tam) == 64 and {t for _, t in tam} == set(range(16))
        assert {v.kind for v in x.variants} == {"instance", "scalar", "point"}
