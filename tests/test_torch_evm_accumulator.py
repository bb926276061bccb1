"""The EVM-accumulator aggregation circuit (`system/evm_accumulator.py`:
snark-verifier-sdk's `example_evm_accumulator.json` shape, here at k = 6
and lookup_bits 5) proved by the port's host prover (EVM and Poseidon
transcripts), and verified by the port on the CPU (every kernel's plain
version) beside the benchmark's plain reference (`perfbench/reference`:
python ints, no torch, no JAX).

Lanes: a valid proof; an accumulator limb moved (the old accumulator
decodes off the curve, which `Snark.validate` refuses); a proof whose
witness carries an accumulator on the curve that the decider refuses
(lhs ≠ τ·rhs); a valid proof whose instances were swapped for another
valid accumulator's limbs (the copy from the advice cells broken); a proof
scalar moved; a proof point moved along the curve.  One mixed batch gets
the reference's accept bits from `batch_verify` and from
`batch_verify_sharded` over two CPU devices, the refused lane answered
False in its own lane; `Snark.validate` and `batch_succinct_verify` still
raise on it; a batch of refused lanes launches nothing.  The valid lanes'
two accumulators (the fresh one, the old one decoded from the limbs)
equal the reference's in both transcripts.  A vanilla circuit with its
instance column in the permutation proves, verifies, and refuses an
instance that breaks its copy.

Tolerance: exact (accept bits, affine ints, counts)."""

import contextlib
import importlib
import random
import sys
from pathlib import Path

import pytest
import torch

from snark_verifier_tpu_torch import _launch, errors
from snark_verifier_tpu_torch.ec import py_ec, to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.parallel import Mesh, batch_verify, batch_verify_sharded
from snark_verifier_tpu_torch.pcs.kzg.accumulator import (
    accumulator_from_limbs_int, accumulator_to_limbs_int,
)
from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system.evm_accumulator import (
    ACCUMULATOR_INDICES, evm_accumulator_circuit, valid_accumulator,
)
from snark_verifier_tpu_torch.system.vanilla_plonk import (
    Assignment, CircuitSpec, Col, compile_protocol, gen_snark,
)
from snark_verifier_tpu_torch.utils import timing
from snark_verifier_tpu_torch.verifier.plonk.verifier import verify_snark_native

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "perfbench"))
import reference  # noqa: E402  the benchmark's plain reference
from reference.protocol import PlonkProtocol as RefProtocol  # noqa: E402

R = FR.p
K, LOOKUP_BITS = 6, 5
LANES = ["valid", "limb_moved", "wrong_acc", "copy_broken", "scalar", "point"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    srs = toy_srs(1 << K)
    circuit = evm_accumulator_circuit(K, LOOKUP_BITS)
    protocol = circuit.protocol(srs, device="cpu")
    rng = random.Random(20260)

    def prove(acc, transcript="evm", check=True):
        asg = circuit.assignment(accumulator_to_limbs_int(acc), rng.getrandbits(64))
        return gen_snark(asg, protocol, srs, scheme="shplonk", seed=rng.getrandbits(64),
                         transcript=transcript, check=check, device="cpu")

    good = lambda: valid_accumulator(srs.tau, rng.randrange(1, R))
    valid, valid2 = prove(good()), prove(good())
    lhs_bad = py_ec.scalar_mul(py_ec.G1_GEN, rng.randrange(1, R))
    wrong_acc = prove((lhs_bad, good()[1]), check=False)
    poseidon = prove(good(), transcript="poseidon")

    def moved(s, instances=None, scalars=None, points=None):
        return Snark(s.protocol, instances or [list(c) for c in s.instances],
                     scalars or list(s.scalars), points or list(s.points))

    limb = [list(valid.instances[0])]
    limb[0][4] = (limb[0][4] + 12345) % R
    high = [list(valid2.instances[0])]
    high[0][11] = (high[0][11] + (1 << 100)) % R  # above the 88 bits the decode keeps
    limb2 = [list(valid2.instances[0])]
    limb2[0][0] = (limb2[0][0] + 1) % R
    sc = list(valid.scalars)
    sc[7] = (sc[7] + 1) % R
    pts = list(valid2.points)
    pts[3] = py_ec.add(pts[3], py_ec.G1_GEN)
    lanes = {
        "valid": valid, "valid2": valid2, "wrong_acc": wrong_acc,
        "limb_moved": moved(valid, instances=limb), "limb_moved2": moved(valid2, instances=limb2),
        "limb_high": moved(valid2, instances=high),
        "copy_broken": moved(valid, instances=[accumulator_to_limbs_int(good())]),
        "scalar": moved(valid, scalars=sc), "point": moved(valid2, points=pts),
    }
    ref_protocol = RefProtocol.from_json(protocol.to_json())
    ref_srs = reference.ToySrs(srs.g, srs.tau)

    def ref(s, transcript="evm", job="verdict"):
        rs = reference.Snark(ref_protocol, [list(c) for c in s.instances], list(s.scalars),
                             list(s.points))
        if job == "verdict":
            return reference.verdict(rs, ref_srs, "shplonk", transcript)
        return reference.succinct_verify(rs, ref_srs.g, "shplonk", transcript)

    return srs, protocol, lanes, poseidon, ref


def _fresh(s):
    """A copy with nothing memoized: each batch screens and packs anew."""
    return Snark(s.protocol, [list(c) for c in s.instances], list(s.scalars), list(s.points))


def _affine(accs):
    return [[(a, b) for a, b in zip(to_affine_int(words_to_limbs(lhs)),
                                    to_affine_int(words_to_limbs(rhs)))] for lhs, rhs in accs]


def test_the_protocol_has_the_published_shape(setup):
    _, protocol, lanes, _, _ = setup
    assert protocol.accumulator_indices == ACCUMULATOR_INDICES
    assert protocol.num_instance == [12]
    assert sorted({q.rotation for q in protocol.queries}) == [-6, -1, 0, 1, 2, 3]
    assert protocol.num_witness == [6, 2, 6]  # 6 advice; the lookup's pair; 4 z + lookup z + random
    assert protocol.quotient.num_chunk() == 3
    assert len(protocol.preprocessed) == 7 + 8  # 7 fixed columns, 8 permuted columns' sigmas
    assert (len(lanes["valid"].scalars), len(lanes["valid"].points)) == (53, 19)


def test_the_reference_decides_every_lane(setup):
    _, _, lanes, poseidon, ref = setup
    got = {name: ref(s) for name, s in lanes.items()}
    assert got == {name: name.startswith("valid") for name in lanes}
    assert ref(poseidon, "poseidon")
    with pytest.raises(errors.InvalidInstances):
        lanes["limb_moved"].validate()
    assert lanes["limb_high"].screen()  # the transcript refuses it, not the screen


class _Recorder:
    """Stands in for torch's record function while a profiler "runs": each
    span's name and the name of the span open around it."""

    def __init__(self):
        self.open, self.spans = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        self.spans.append((name, self.open[-1] if self.open else None))
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()


def test_a_mixed_batch_answers_each_lane_as_the_reference(setup, monkeypatch):
    """Its bits, its count of refused lanes, and the screen and the decode
    as steps and spans of their own."""
    srs, _, lanes, _, ref = setup
    batch = [_fresh(lanes[n]) for n in LANES]
    want = [ref(lanes[n]) for n in LANES]
    rec = _Recorder()
    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(timing, "_record", rec)
    _launch.reset_launches()
    timings = {}
    oks = batch_verify(batch, srs, "shplonk", "evm", device="cpu", timings=timings)
    assert oks.dtype == torch.bool and oks.tolist() == want
    assert _launch.COUNTERS["lanes_invalid"] == 1
    assert {"screen_s", "acc_decode_s", "msm_s", "decide_s"} <= set(timings)
    parents = dict(rec.spans)
    assert parents["svt::verify.screen"] == "svt::verify"
    assert parents["svt::verify.acc_decode"] == "svt::verify.succinct"
    names = [n for n, _ in rec.spans]
    assert names.index("svt::verify.msm") < names.index("svt::verify.acc_decode")
    monkeypatch.setattr(Snark, "validate", None)  # the screen is memoized on each lane
    assert [s.screen() for s in batch] == [n != "limb_moved" for n in LANES]
    monkeypatch.undo()
    for name in ("limb_moved", "limb_moved2"):  # the screen leaves the refusal where it was
        with pytest.raises(errors.InvalidInstances):
            _fresh(lanes[name]).validate()
        with pytest.raises(errors.InvalidInstances):
            batch_succinct_verify([_fresh(lanes[name])], srs, "shplonk", "evm", device="cpu")


def test_the_sharded_batch_answers_as_one_device(setup):
    srs, _, lanes, _, ref = setup
    batch = [_fresh(lanes[n]) for n in LANES]
    oks = batch_verify_sharded(batch, srs, Mesh(["cpu"] * 2, ("batch",)), "shplonk",
                               transcript="evm")
    assert oks.tolist() == [ref(lanes[n]) for n in LANES]


def test_a_batch_of_refused_lanes_is_all_false_without_a_phase(setup, monkeypatch):
    srs, _, lanes, _, _ = setup
    bv = importlib.import_module("snark_verifier_tpu_torch.parallel.batch_verify")
    monkeypatch.setattr(bv, "batch_succinct_verify_sharded", None)  # must not be reached
    _launch.reset_launches()
    timings = {}
    oks = batch_verify([_fresh(lanes["limb_moved"]), _fresh(lanes["limb_moved2"])], srs,
                       "shplonk", "evm", device="cpu", timings=timings)
    assert oks.tolist() == [False, False] and set(timings) == {"screen_s"}
    assert _launch.COUNTERS["lanes_invalid"] == 2
    _launch.reset_launches()
    assert "lanes_invalid" not in _launch.COUNTERS


@pytest.mark.parametrize("transcript", ["evm", "poseidon"])
def test_the_valid_lanes_two_accumulators_equal_the_references(setup, transcript):
    srs, _, lanes, poseidon, ref = setup
    snarks = [lanes["valid"], lanes["valid2"]] if transcript == "evm" else [poseidon]
    got = _affine(batch_succinct_verify([_fresh(s) for s in snarks], srs, "shplonk", transcript,
                                        device="cpu"))
    assert len(got) == 2  # the fresh accumulator, then the old one of the limbs
    for j, s in enumerate(snarks):
        want = ref(s, transcript, "accumulators")
        assert [acc[j] for acc in got] == [tuple(a) for a in want]
        assert want[1] == accumulator_from_limbs_int(s.instances[0])


def test_an_instance_column_in_the_permutation_holds_its_copy():
    """A vanilla circuit (k = 4): advice a with a·a = b on row 2, the
    instance copied from a on row 2 and from b on row 2 of column b's copy."""
    srs = toy_srs(16)
    spec = CircuitSpec(k=4, num_fixed=1, num_advice=[2], num_instance=[2],
                       permutation_columns=[Col("advice", 0), Col("advice", 1),
                                            Col("instance", 0)])
    a, b, q = spec.advice(0), spec.advice(1), spec.fixed(0)
    spec.gates = [q * (a * a - b)]
    n = 1 << 4
    fixed = [[1 if r == 2 else 0 for r in range(n)]]
    A, B, I = Col("advice", 0), Col("advice", 1), Col("instance", 0)
    copies = [((A, 2), (I, 0)), ((B, 2), (I, 1))]
    protocol = compile_protocol(spec, fixed, copies, srs, device="cpu")
    x = 0x1234567
    adv = [[(r + 11) * 7 % R for r in range(n)] for _ in range(2)]
    adv[0][2], adv[1][2] = x, x * x % R
    asg = Assignment(spec=spec, fixed=fixed, advice_phases=[adv], instance=[[x, x * x % R]],
                     copies=copies)
    snark = gen_snark(asg, protocol, srs, scheme="shplonk", seed=5, device="cpu")
    assert verify_snark_native(snark, srs)
    broken = Snark(protocol, [[x + 1, (x + 1) * (x + 1) % R]], snark.scalars, snark.points)
    assert not verify_snark_native(broken, srs)
    with pytest.raises(ValueError):  # the prover refuses a witness that breaks the copy
        bad = Assignment(spec=spec, fixed=fixed, advice_phases=[adv],
                         instance=[[x + 1, (x + 1) * (x + 1) % R]], copies=copies)
        gen_snark(bad, protocol, srs, scheme="shplonk", seed=5, device="cpu")
