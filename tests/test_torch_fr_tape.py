"""The recorded Fr program of the succinct verifier (ff/fr_tape.py,
loader/tape_loader.py, verifier/plonk/plan.py) on the CPU: the plan's
counts for vanilla PLONK k=10; `run_plain` on three fixture lanes against
the eager `TorchLoader` path (its MSM scalars and bases, captured around
`msm_windowed` as chip_smoke.py captures them); the plan path's
accumulators against the JAX package's `succinct_verify_native`; the
recorded batch inversion's zeros; the plan cache; and a recorder that
refuses what it cannot record.

Tolerance: exact (canonical words; accumulators as affine ints)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.verifier.plonk.verifier import succinct_verify_native as j_native
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FR, FRW
from snark_verifier_tpu_torch.ff import fr_tape as ft
from snark_verifier_tpu_torch.loader.base import TorchLoader
from snark_verifier_tpu_torch.loader.tape_loader import TapeLoader, TapeTranscript
from snark_verifier_tpu_torch.msm import cuda_ops
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
from snark_verifier_tpu_torch.sdk import aggregation as agg
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params
from snark_verifier_tpu_torch.transcript import PoseidonTranscript
from snark_verifier_tpu_torch.verifier.plonk import plan as plan_mod
from snark_verifier_tpu_torch.verifier.plonk.plan import SuccinctPlan, succinct_plan
from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkSuccinctVerifier

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
LANES = [0, 3, 7]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snarks():
    return [Snark.load(str(FIXTURES / f"snark_{i:02d}.json")) for i in LANES]


def _protocol():
    return Snark.load(str(FIXTURES / "snark_00.json")).protocol


def _eager(snarks, srs):
    """The eager TorchLoader succinct verify: every Fr op one call."""
    protocol, B = snarks[0].protocol, len(snarks)
    sc, pts = agg._stack_streams(snarks, CPU)
    inst = agg._stack_instances(snarks, CPU)
    L = TorchLoader(B, CPU)
    proof = PlonkSuccinctVerifier.read_proof(protocol, inst, PoseidonTranscript(sc, pts, CPU),
                                             Bdfg21, L)
    return PlonkSuccinctVerifier.verify(srs.g_dev(CPU), protocol, inst, proof, Bdfg21, L)


def _plain_int(words) -> int:
    """A canonical plain (8,) word tensor -> its python int."""
    return int.from_bytes(words.numpy().astype("<u4").tobytes(), "little")


def _affine(accs):
    (lhs, rhs), = accs
    return list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))


@pytest.fixture(scope="module")
def runs():
    """The eager and the plan path on the same three lanes, each with the
    (bases, canonical scalars) it handed to msm_windowed."""
    srs = load_params(str(FIXTURES / "srs.bin"))
    seen = {"eager": [], "plan": []}
    real = cuda_ops.msm_windowed
    out = {}
    for name, fn in (("eager", lambda s: _eager(s, srs)),
                     ("plan", lambda s: agg.batch_succinct_verify(s, srs, device="cpu"))):
        def capture(pts, scalars, c=4, _seen=seen[name]):
            _seen.append((pts, scalars))
            return real(pts, scalars, c)

        cuda_ops.msm_windowed = capture
        try:
            out[name] = _affine(fn(_snarks()))
        finally:
            cuda_ops.msm_windowed = real
    return out, seen


def test_vanilla_k10_plan_counts():
    plan = succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon")
    tape = plan.tape
    # one accumulator: lhs the verify MSM's 26 scaled terms, rhs one point
    assert [(len(lhs.scaled), len(lhs.plain), len(rhs.scaled), len(rhs.plain))
            for lhs, rhs in plan.accs] == [(26, 0, 0, 1)]
    assert tape.op_counts() == {"mul": 328, "add": 111, "sub": 12, "neg": 68, "inv": 3,
                                "one_if_zero": 23, "zero_if_zero": 23, "out": 26}
    assert tape.n_slots == 40 <= ft.MAX_SLOTS
    assert (len(tape.inputs), len(tape.outputs), plan.n_points) == (35, 26, 16)
    # the reference's counts (an INV as Fermat's 381 multiplies)
    assert tape.muls() == 328 + 26 + 3 * ft.INV_MULS == 1497
    # the CPE's inversion runs beside SHPLONK's first; its second follows
    assert 2 * ft.INV_MULS < tape.chain_muls() == 797 < 3 * ft.INV_MULS
    assert tape.chain((tape.rows[:, 0] == ft.INV).astype(int)) == 2  # INV rows on the chain
    # the kernel's team schedules: steps, multiply steps, inversion steps
    got = {t: tape.schedule(t).counts() for t in ft.TEAMS}
    assert {t: (c["steps"], c["product_steps"] + c["square_steps"], c["invert_steps"])
            for t, c in got.items()} == {1: (594, 354, 3), 2: (305, 181, 2), 4: (168, 96, 2),
                                         8: (109, 63, 2)}
    # every operand names a live slot, an input row or a constant
    kinds = tape.rows[:, 2:] >> ft.KIND_SHIFT
    idx = tape.rows[:, 2:] & ft.INDEX_MASK
    assert set(np.unique(kinds)) <= {ft.SLOT, ft.INPUT, ft.CONST}
    assert idx[kinds == ft.INPUT].max() < len(tape.inputs)
    assert idx[kinds == ft.CONST].max() < tape.consts.shape[0]
    assert tape.rows[tape.rows[:, 0] != ft.OUT, 1].max() < tape.n_slots


def test_least_work_counts_an_addition_chain():
    # every width's chain computes x^(r - 2); the least is ~60 products
    x = 0x1234_5678_9ABC_DEF0_1357
    for w in range(1, 9):
        steps, res = ft.window_chain(FR.p - 2, w)
        vals = [x]
        for a, b in steps:
            vals.append(vals[a] * vals[b] % FR.p)
        assert vals[res] == pow(x, FR.p - 2, FR.p)
    best = min((ft.window_chain(FR.p - 2, w)[0] for w in range(1, 9)), key=ft.chain_muladds)
    squares = sum(a == b for a, b in best)
    assert (squares, len(best) - squares) == (253, 56)
    assert ft.inv_least_muladds() == 253 * ft.MULADDS_SQR + 56 * ft.MULADDS_MUL
    # the vanilla_k10 plan: the kernel's work and the least, each row's and
    # along the longest chain
    tape = succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon").tape
    kernel, least = tape.row_muladds(), tape.row_muladds(least=True)
    inv_kernel = 254 * ft.MULADDS_SQR + (ft.INV_MULS - 254) * ft.MULADDS_MUL
    squares = int(((tape.rows[:, 0] == ft.MUL) & (tape.rows[:, 2] == tape.rows[:, 3])).sum())
    assert squares == 12
    assert int(kernel.sum()) == ((328 - 12) * 136 + 12 * 108 + 26 * 136 + 3 * inv_kernel) == 181_920
    assert int(least.sum()) == ((328 - 12) * 136 + 12 * 108 + 26 * 72
                                + 3 * ft.inv_least_muladds()) == 150_964
    assert tape.chain(least) == 74_576 < tape.chain(kernel) == 94_168


def test_gather_holds_the_reads_to_the_tape_inputs():
    plan = succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon")

    class Stream:  # a transcript that hands out zeros
        def squeeze_challenge(self):
            return torch.zeros(8, dtype=torch.int32)

        read_scalar = squeeze_challenge

    instances = [[torch.zeros(8, dtype=torch.int32)] * n for n in _protocol().num_instance]
    reads = [lab for lab in plan.tape.inputs if lab[0] != "instance"]
    assert reads[0] == ("challenge", 0)
    tr = TapeTranscript(inner=Stream())
    for kind, _ in reads:
        tr.squeeze_challenge() if kind == "challenge" else tr.read_scalar()
    assert tr.labels == reads
    assert tuple(plan.gather(instances, tr, 2).shape) == (len(plan.tape.inputs), 2, 8)
    swapped = TapeTranscript(inner=Stream())  # a scalar read where a challenge is squeezed
    swapped.read_scalar()
    for _ in reads[1:]:
        swapped.squeeze_challenge()
    with pytest.raises(ValueError):
        plan.gather(instances, swapped, 2)
    with pytest.raises(ValueError):  # an instance column one short
        plan.gather([col[:-1] for col in instances], tr, 2)
    with pytest.raises(ValueError):  # records or runs, not both or neither
        TapeTranscript()


def test_plan_scalars_match_eager_word_for_word(runs):
    _, seen = runs
    (ep, es), = seen["eager"]
    (pp_, ps), = seen["plan"]
    assert tuple(ps.shape) == (len(LANES), 26, 8)
    assert torch.equal(ps, es)
    assert torch.equal(pp_, ep)


def test_plan_accumulators_match_jax_native(runs):
    out, _ = runs
    srs_j = j_load_params(str(FIXTURES / "srs.bin"))
    want = [j_native(JSnark.load(str(FIXTURES / f"snark_{i:02d}.json")), srs_j)[0] for i in LANES]
    assert out["plan"] == want
    assert out["eager"] == want


def test_recorded_batch_inv_maps_zeros_to_zero():
    L = TapeLoader()
    xs = [L.input(k) for k in range(5)]
    for k, y in enumerate(L.batch_inv(xs)):
        L.output(y, k)
    tape = L.finish()
    vals = [[3, 0, 7], [0, 0, 5], [11, 2, 0], [FR.p - 1, 9, 0], [0, 0, 0]]  # per input, 3 lanes
    inputs = torch.stack([FRW.from_int(v) for v in vals], 0)
    out = ft.run_plain(tape, inputs)
    got = [[_plain_int(w) for w in row] for row in out]
    assert got == [[pow(v, FR.p - 2, FR.p) if v else 0 for v in row] for row in vals]


def test_plan_is_recorded_once_per_protocol(monkeypatch):
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    a = succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon")
    assert succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon") is a  # another object, same content
    d = json.loads((FIXTURES / "snark_00.json").read_text())
    d["protocol"]["transcript_initial_state"] = hex(12345)
    edited = Snark.from_json(d).protocol
    assert edited.content_hash() != _protocol().content_hash()
    b = succinct_plan(edited, Bdfg21, "shplonk", "poseidon")
    assert b is not a and len(plan_mod._PLANS) == 2
    assert np.array_equal(b.tape.rows, a.tape.rows)  # the same algebra, its own plan


def test_recorder_refuses_and_runs_nothing(monkeypatch):
    L = TapeLoader()
    x = L.input("x")
    for bad in (lambda: int(x), lambda: bool(x), lambda: torch.stack([x, x]),
                lambda: L.mul(x, torch.zeros(8, dtype=torch.int32)),
                lambda: L.msm_base(torch.zeros((1, 2, 8), dtype=torch.int32)),
                lambda: L.msm_evaluate(L.msm_zero(), torch.zeros((3, 8), dtype=torch.int32)),
                lambda: L.decide_all(None, [])):
        with pytest.raises(errors.InvalidProtocol):
            bad()

    def eager(*_a, **_k):
        raise AssertionError("an eager field or group op ran while recording")

    for name in ("_binary", "_unary", "plain"):
        monkeypatch.setattr(FRW, name, eager)
    monkeypatch.setattr(cuda_ops, "msm_windowed", eager)
    monkeypatch.setattr(cuda_ops, "add", eager)
    plan = SuccinctPlan(_protocol(), Bdfg21)
    assert len(plan.tape.rows) == 594


def test_run_takes_only_a_card_tensor_and_slots_are_bounded():
    plan = succinct_plan(_protocol(), Bdfg21, "shplonk", "poseidon")
    inputs = torch.zeros((len(plan.tape.inputs), 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):  # the kernel's wrapper: run_plain is the CPU's
        ft.run(plan.tape, inputs)
    with pytest.raises(ValueError):
        ft.run_plain(plan.tape, inputs[:-1])
    # a program that keeps more values live than the slot file holds
    L = TapeLoader()
    sq = [L.mul(x, x) for x in (L.input(k) for k in range(ft.MAX_SLOTS + 3))]
    acc = sq[0]
    for v in sq[1:]:
        acc = L.add(acc, v)
    L.output(acc, "sum")
    with pytest.raises(errors.InvalidProtocol):
        L.finish()
