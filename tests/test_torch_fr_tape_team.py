"""The team schedule of the recorded Fr program (`ff/fr_tape.py::schedule`,
the order `svt_fr_tape` runs a tape in) and the plain twin's inversion, on
the CPU.

* A plain interpreter of each schedule, written here as the kernel runs it
  (a step's operands all read before any of its results is written, the
  schedule's own slot numbers), equals `run_plain` word for word on every
  row's value (so on every live slot) and on every output: the recorded
  SHPLONK (vanilla k=10), GWC19 and IPA k = 11 tapes at T = 1, 2, 4 and 8,
  on lanes of fixture inputs (SHPLONK, GWC19), random lazy words from a
  numpy seed and zeros.
* The scheduler's invariants on those schedules: every row placed exactly
  once and after its operands' rows, one op class a step, no slot read and
  written in one step, the slot count within the file; T = 1 the tape in
  order; independent inversions share a step.
* `run_plain`'s INV (Fermat after canon) equals the JAX package's
  `LimbField.inv` after `canon` on numpy-seeded words, 0 and p among them.

Tolerance: exact."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.ff.spec import int_to_limbs as j_int_to_limbs
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ff import FR, limbs_to_words, words_to_limbs
from snark_verifier_tpu_torch.ff import fr_tape as ft
from snark_verifier_tpu_torch.loader.base import TorchLoader
from snark_verifier_tpu_torch.pcs.ipa import fixtures as ipa_fx
from snark_verifier_tpu_torch.pcs.ipa import ipa_plan
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
from snark_verifier_tpu_torch.sdk import aggregation as agg
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.transcript import PoseidonTranscript
from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

from test_torch_fr_tape_schedule import FIXTURES, _lazy_words

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture_inputs(plan, prefix, lanes):
    snarks = [Snark.load(str(FIXTURES / f"{prefix}_{i:02d}.json")) for i in lanes]
    sc, pts = agg._stack_streams(snarks, CPU)
    inst = agg._stack_instances(snarks, CPU)
    reads = plan.read(inst, PoseidonTranscript(sc, pts, CPU), TorchLoader(len(lanes), CPU))
    return plan.gather(inst, reads, len(lanes))


@pytest.fixture(scope="module")
def tapes():
    """{name: (tape, inputs)}: (n_in, 4, 8) blocks of two fixture lanes (or
    two random ones for IPA), a lane of random lazy words and one of zeros."""
    out = {}
    for name, prefix, scheme, multiopen in (("shplonk", "snark", "shplonk", Bdfg21),
                                           ("gwc19", "gwcsnark", "gwc", Gwc19)):
        first = Snark.load(str(FIXTURES / f"{prefix}_00.json"))
        plan = succinct_plan(first.protocol, multiopen, scheme, "poseidon")
        out[name] = (plan.tape, _fixture_inputs(plan, prefix, [0, 1]))
    tape = ipa_plan("ipa", ipa_fx.ipa_keys()[0].svk, device="cpu").tape
    out["ipa_k11"] = (tape, _lazy_words(np.random.default_rng(11), 2 * len(tape.inputs))
                      .reshape(len(tape.inputs), 2, 8))
    for k, (name, (tape, ins)) in enumerate(sorted(out.items())):
        n_in = ins.shape[0]
        rand = _lazy_words(np.random.default_rng(100 + k), n_in)[:, None]
        zeros = torch.zeros((n_in, 1, 8), dtype=torch.int32)
        out[name] = (tape, torch.cat([ins, rand, zeros], 1).contiguous())
    return out


@pytest.fixture(scope="module")
def reference(tapes):
    """run_plain's outputs and every row's value, per tape."""
    ref = {}
    for name, (tape, ins) in tapes.items():
        values = []
        ref[name] = (ft.run_plain(tape, ins, values), values)
    return ref


def run_schedule(tape, sched, inputs):
    """The schedule as the kernel runs it: each step reads all its operands
    from the schedule's slots, then writes its results.  -> (outputs, the
    value of each tape row, the tape row whose value each read found)."""
    B = inputs.shape[1]
    consts = torch.from_numpy(tape.consts)
    slots = [None] * sched.n_slots
    holder = [-1] * sched.n_slots  # the tape row whose value a slot holds
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32)
    values = [None] * len(tape.rows)
    seen = []
    for step, order in zip(sched.steps.tolist(), sched.order.tolist()):
        reads = []
        for (op, dst, s1, s2), i in zip(step, order):
            if op == ft.NOP:
                continue
            codes = (s1, s2) if op in ft.BINARY else (s1,)
            a, *b = (ft.fetch_plain(c, slots, inputs, consts) for c in codes)
            seen.append((i, [holder[c & ft.INDEX_MASK] if c >> ft.KIND_SHIFT == ft.SLOT else -1
                             for c in codes]))
            reads.append((i, op, dst, a, b[0] if b else None))
        for i, op, dst, a, b in reads:
            values[i] = ft.plain_row(op, a, b, B)
            if op == ft.OUT:
                out[dst] = values[i]
            else:
                slots[dst], holder[dst] = values[i], i
    return out, values, seen


def _producers(tape):
    """For each row, the tape row that wrote each slot operand (-1 if not a
    slot), in the tape's order."""
    writer, srcs = {}, []
    for i, (op, dst, s1, s2) in enumerate(tape.rows.tolist()):
        codes = (s1, s2) if op in ft.BINARY else (s1,)
        srcs.append([writer[c & ft.INDEX_MASK] if c >> ft.KIND_SHIFT == ft.SLOT else -1
                     for c in codes])
        if op != ft.OUT:
            writer[dst] = i
    return srcs


@pytest.mark.parametrize("team", ft.TEAMS)
@pytest.mark.parametrize("name", ["shplonk", "gwc19", "ipa_k11"])
def test_schedule_interpreter_matches_run_plain(tapes, reference, name, team):
    tape, ins = tapes[name]
    sched = ft.schedule(tape, team)
    got, values, seen = run_schedule(tape, sched, ins)
    want, want_values = reference[name]
    assert torch.equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(values, want_values))
    srcs = _producers(tape)
    assert sorted(i for i, _ in seen) == list(range(len(tape.rows)))
    assert all(found == srcs[i] for i, found in seen)  # each read finds its producer's value
    # the lanes differ: fixture, random and zero lanes are not one lane
    assert not torch.equal(want[:, 0], want[:, 2]) and not torch.equal(want[:, 2], want[:, 3])


@pytest.mark.parametrize("team", ft.TEAMS)
@pytest.mark.parametrize("name", ["shplonk", "gwc19", "ipa_k11"])
def test_schedule_invariants(tapes, name, team):
    tape, _ = tapes[name]
    sched = tape.schedule(team)
    assert tape.schedule(team) is sched  # made once, on the tape
    rows = tape.rows.tolist()
    placed = sched.order[sched.order >= 0]
    assert sorted(placed.tolist()) == list(range(len(rows)))  # every row exactly once
    assert sched.steps.shape == (sched.n_steps, team, 4)
    assert ((sched.order < 0) == (sched.steps[:, :, 0] == ft.NOP)).all()
    step_of = {int(i): k for k, order in enumerate(sched.order) for i in order if i >= 0}
    for i, src in enumerate(_producers(tape)):
        assert all(step_of[p] < step_of[i] for p in src if p >= 0)  # after its operands
    for k, (step, order) in enumerate(zip(sched.steps.tolist(), sched.order.tolist())):
        live = [(row, i) for row, i in zip(step, order) if i >= 0]
        assert live and order[:len(live)] == [i for _, i in live]  # NOPs at the end
        classes = {ft.row_class(op, s1, s2) for (op, _, s1, s2), _ in live}
        assert classes == {sched.classes[k]}  # one op class a step
        assert all(row[0] == rows[i][0] for row, i in live)
        read = {c & ft.INDEX_MASK for (op, _, s1, s2), _ in live
                for c in ((s1, s2) if op in ft.BINARY else (s1,)) if c >> ft.KIND_SHIFT == ft.SLOT}
        written = [dst for (op, dst, _, _), _ in live if op != ft.OUT]
        assert not read & set(written) and len(set(written)) == len(written)
    assert sched.steps[sched.steps[:, :, 0] != ft.OUT][:, 1].max() < sched.n_slots
    # the schedule's slots, then the inputs and constants the kernel copies in
    assert sched.n_slots + len(tape.inputs) + tape.consts.shape[0] <= ft.MAX_SLOTS * team
    n_inv = tape.op_counts()["inv"]
    if team == 1:
        assert sched.order[:, 0].tolist() == list(range(len(rows)))  # the tape in order
        assert sched.counts()["invert_steps"] == n_inv
    else:  # inversions that depend on none of the others share a step
        assert sched.counts()["invert_steps"] == tape.chain((tape.rows[:, 0] == ft.INV)
                                                              .astype(int))


def test_schedule_counts_and_refusals():
    tape = succinct_plan(Snark.load(str(FIXTURES / "snark_00.json")).protocol, Bdfg21,
                         "shplonk", "poseidon").tape
    counts = {t: tape.schedule(t).counts() for t in ft.TEAMS}
    assert counts[1] == {"steps": 594, "product_steps": 342, "square_steps": 12,
                         "invert_steps": 3, "cheap_steps": 237}
    steps = [counts[t]["steps"] for t in ft.TEAMS]
    assert steps == sorted(steps, reverse=True) and steps[-1] < 594 // 4
    # the CPE's inversion and SHPLONK's first share a step; the second follows
    assert [counts[t]["invert_steps"] for t in ft.TEAMS] == [3, 2, 2, 2]
    with pytest.raises(ValueError):
        tape.schedule(3)
    bad = ft.FrTape(rows=np.array([(ft.NEG, 0, (ft.SLOT << ft.KIND_SHIFT) | 4, 0),
                                   (ft.OUT, 0, ft.SLOT << ft.KIND_SHIFT, 0)], np.int32),
                    consts=np.zeros((1, 8), np.int32), inputs=[], outputs=["x"], n_slots=5)
    with pytest.raises(errors.InvalidProtocol):  # reads a slot no row wrote
        ft.schedule(bad, 2)
    # 300 squares of 300 inputs, then their sum: past the file at T = 1 (the
    # tape in order), within it at T = 8
    wide = ft.FrTape(rows=np.array([(ft.MUL, k, (ft.INPUT << ft.KIND_SHIFT) | k,
                                     (ft.INPUT << ft.KIND_SHIFT) | k) for k in range(300)]
                                   + [(ft.ADD, 0, ft.SLOT << ft.KIND_SHIFT,
                                       (ft.SLOT << ft.KIND_SHIFT) | k) for k in range(1, 300)]
                                   + [(ft.OUT, 0, ft.SLOT << ft.KIND_SHIFT, 0)], np.int32),
                     consts=np.zeros((1, 8), np.int32), inputs=list(range(300)),
                     outputs=["sum"], n_slots=300)
    with pytest.raises(errors.InvalidProtocol):
        ft.schedule(wide, 1)
    assert ft.schedule(wide, 8).n_slots + 301 <= 8 * ft.MAX_SLOTS


def test_run_plain_inv_is_jax_limb_field_inv_after_canon():
    rng = np.random.default_rng(19)
    xs = [0, FR.p, 2 * FR.p, 1, FR.p - 1, FR.p + 1, 2 * FR.p - 1]
    xs += [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(57)]
    limbs = np.stack([j_int_to_limbs(x) for x in xs])
    words = limbs_to_words(torch.from_numpy(limbs.astype(np.int64)))
    got = ft.plain_row(ft.INV, words, None, len(xs))
    want = np.asarray(JFR.canon(JFR.inv(limbs)))
    assert np.array_equal(words_to_limbs(got).numpy(), want)
    R = 1 << 256
    ints = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in want]
    assert ints == [pow(x, FR.p - 2, FR.p) * R * R % FR.p for x in xs]  # A R -> A^-1 R
    assert ints[:3] == [0, 0, 0]
