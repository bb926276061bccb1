"""The keccak (EVM) read as one recorded schedule, on the CPU.

The verify path reads a keccak batch in one launch of `svt_keccak_read`
over a schedule recorded once per protocol
(`verifier/plonk/plan.py::keccak_schedule`), then reads the proofs through
`PrecomputedChallengeTranscript`.  Here:

* the `evmsnark` protocol's recorded schedule: nine squeezes of 8, 3, 5, 1,
  9, 9, 26, 1 and 3 words, 21 permutations a proof, each buffer after the
  first starting with the previous hash;
* `read_plain`'s challenges (the planned read on CPU tensors) against the
  port's eager read (`read_proof` through the running `TapeTranscript` over
  `EvmTranscript`), the JAX package's device `EvmTranscript` under its
  `read_proof` (jitted) and `EvmTranscriptPy`'s python ints, on a batch of
  `evmsnark` fixtures and on a GWC19 proof made with the keccak transcript
  by the JAX package's host prover;
* the port's `PrecomputedChallengeTranscript` reads what the JAX package's
  reads (as tests/test_evm_transcript.py uses it), on the same challenges;
* an instance moved by one in one lane changes that lane's challenges only;
* the read kernel's own C++ under g++ (a thread a lane, shuffles through
  barriers: `test_torch_keccak_schedule.read_kernel`) against `read_plain`
  on the fixture batch's whole schedule.

Tolerance: exact (Montgomery words, python ints)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.pcs.kzg.multiopen import Bdfg21 as JBdfg21
from snark_verifier_tpu.sdk.aggregation import _stack_instances as j_stack_instances
from snark_verifier_tpu.sdk.aggregation import _stack_streams as j_stack_streams
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.transcript import EvmTranscript as JEvmTranscript
from snark_verifier_tpu.transcript.evm_transcript import (
    PrecomputedChallengeTranscript as JPrecomputed,
)
from snark_verifier_tpu.verifier.plonk.verifier import PlonkSuccinctVerifier as JVerifier
from snark_verifier_tpu_torch.ff import FR, FRW, limbs_to_words
from snark_verifier_tpu_torch.hash import keccak_device as kd
from snark_verifier_tpu_torch.loader.base import NATIVE, TorchLoader
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
from snark_verifier_tpu_torch.sdk import aggregation as agg
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.transcript import (
    EvmTranscript,
    EvmTranscriptPy,
    PrecomputedChallengeTranscript,
)
from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan
from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkSuccinctVerifier

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
CPU = torch.device("cpu")
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lanes():
    """Three evmsnark fixtures, the second with its first instance + 1."""
    names = [FIXTURES / f"evmsnark_{i:02d}.json" for i in range(B)]
    ours = [Snark.load(str(n)) for n in names]
    ours[1].instances[0][0] = (ours[1].instances[0][0] + 1) % FR.p
    theirs = [JSnark.load(str(n)) for n in names]
    theirs[1].instances[0][0] = ours[1].instances[0][0]
    return ours, theirs


def _plan(snarks, scheme_name="shplonk"):
    s = snarks[0]
    return succinct_plan(s.protocol, agg.SCHEMES[scheme_name], scheme_name, "evm")


def _streams(snarks):
    sc, pts = agg._stack_streams(snarks, CPU)
    return agg._instance_block(snarks, CPU), sc, pts


def _oracle(snarks, scheme):
    """Each lane's challenges from EvmTranscriptPy, in squeeze order."""
    out = []
    for s in snarks:
        t = EvmTranscriptPy(s.scalars, s.points)
        PlonkSuccinctVerifier.read_proof(s.protocol, [list(c) for c in s.instances], t, scheme,
                                         NATIVE)
        out.append(t.challenges)
    return out


def _ints(chals):
    """(n_sq, B, 8) lazy words -> [lane][squeeze] canonical ints."""
    return [[int(v) for v in FRW.to_int(chals[:, b])] for b in range(chals.shape[1])]


def test_evmsnark_schedule_is_the_nine_buffers(lanes):
    plan = _plan(lanes[0])
    sched = plan.keccak
    assert sched.widths == [8, 3, 5, 1, 9, 9, 26, 1, 3]
    assert sum(kd.pad_lanes(w)[1] for w in sched.widths) == 21  # permutations a proof
    for q, sq in enumerate(sched.squeezes[1:], 1):
        assert sq[0] == (kd.SRC_HASH, q - 1, kd.TAG_RAW)
    first = sched.squeezes[0]
    n_inst = sum(plan.protocol.num_instance)
    has_init = plan.protocol.transcript_initial_state is not None
    assert [s for s, _, _ in first[:has_init + n_inst]] == (
        [kd.SRC_CONST] * has_init + [kd.SRC_INSTANCE] * n_inst)
    if has_init:
        assert sched.consts == [plan.protocol.transcript_initial_state % FR.p]
    # every stream word read before the last squeeze is hashed once, in read
    # order: all the scalars, every point but SHPLONK's last (W', read after z')
    sc = [i for sq in sched.squeezes for s, i, _ in sq if s == kd.SRC_SCALAR]
    pts = [i for sq in sched.squeezes for s, i, _ in sq if s == kd.SRC_POINT_X]
    assert sc == list(range(len(lanes[0][0].scalars)))
    assert pts == list(range(len(lanes[0][0].points) - 1))
    tags = {s: t for sq in sched.squeezes for s, _, t in sq}
    assert tags == {kd.SRC_CONST: kd.TAG_RAW, kd.SRC_INSTANCE: kd.TAG_FR,
                    kd.SRC_SCALAR: kd.TAG_FR, kd.SRC_POINT_X: kd.TAG_FQ,
                    kd.SRC_POINT_Y: kd.TAG_FQ, kd.SRC_HASH: kd.TAG_RAW}


def test_read_plain_matches_eager_read_and_oracle(lanes):
    ours, _ = lanes
    plan = _plan(ours)
    inst, sc, pts = _streams(ours)
    hashes, chals = kd.read(plan.keccak, inst, sc, pts)  # CPU tensors: read_plain
    assert tuple(chals.shape) == (9, B, 8) and tuple(hashes.shape) == (9, B, 8)
    instances = agg._instance_columns(inst, plan.protocol.num_instance)
    eager = plan.read(instances, EvmTranscript(sc, pts, CPU), TorchLoader(B, CPU))
    got = [v for (kind, _), v in zip(eager.labels, eager.values) if kind == "challenge"]
    assert torch.equal(torch.stack(got, 0), chals)
    assert _ints(chals) == _oracle(ours, Bdfg21)
    # the planned read hands the same challenges to read_proof
    planned = plan.read_keccak(inst, instances, sc, pts, TorchLoader(B, CPU))
    assert planned.labels == eager.labels
    assert all(torch.equal(a.expand(B, 8), b.expand(B, 8))
               for a, b in zip(planned.values, eager.values))


def test_read_plain_matches_jax_evm_transcript(lanes):
    ours, theirs = lanes
    plan = _plan(ours)
    _, chals = kd.read(plan.keccak, *_streams(ours))
    protocol = theirs[0].protocol
    j_sc, j_pts = j_stack_streams(theirs)
    j_inst = j_stack_instances(theirs)

    class Recording(JEvmTranscript):
        def squeeze_challenge(self):
            c = super().squeeze_challenge()
            self.out.append(c)
            return c

    def run(sc, pts, inst):
        t = Recording(scalars=sc, points=pts, batch_shape=(B,))
        t.out = []
        JVerifier.read_proof(protocol, inst, t, JBdfg21)
        return jnp.stack(t.out, 0)

    want = np.asarray(jax.jit(run)(j_sc, j_pts, j_inst))
    assert torch.equal(limbs_to_words(torch.from_numpy(want.astype(np.int64))), chals)


def test_precomputed_transcript_matches_jax(lanes):
    ours, theirs = lanes
    plan = _plan(ours)
    inst, sc, pts = _streams(ours)
    _, chals = kd.read(plan.keccak, inst, sc, pts)
    host = _oracle(ours, Bdfg21)
    per_squeeze = [[host[b][q] for b in range(B)] for q in range(len(host[0]))]
    # the port's, fed per-lane int lists, device words and a broadcast int
    feeds = [per_squeeze, list(chals), [per_squeeze[0]] + [int(c[0]) for c in per_squeeze[1:]]]
    instances = agg._instance_columns(inst, plan.protocol.num_instance)
    reads = []
    for feed in feeds:
        t = PrecomputedChallengeTranscript(sc, pts, feed)
        proof = PlonkSuccinctVerifier.read_proof(plan.protocol, instances, t, Bdfg21,
                                                 TorchLoader(B, CPU))
        reads.append(proof)
    # the JAX package's on the same per-lane challenge lists
    j_sc, j_pts = j_stack_streams(theirs)
    jt = JPrecomputed(j_sc, j_pts, per_squeeze, batch_shape=(B,))
    jproof = JVerifier.read_proof(theirs[0].protocol, j_stack_instances(theirs), jt, JBdfg21)

    def words(x):
        return limbs_to_words(torch.from_numpy(np.asarray(x).astype(np.int64)))

    def same(a, j):  # the same values (the kernel's challenges are lazy words)
        return list(FRW.to_int(a.expand(B, 8))) == list(FRW.to_int(words(j)))

    for proof in reads[:2]:
        assert len(proof.challenges) == len(jproof.challenges)
        assert all(same(c, j) for c, j in zip(proof.challenges, jproof.challenges))
        assert same(proof.z, jproof.z)
        assert all(torch.equal(e, words(j)) for e, j in zip(proof.evaluations,
                                                             jproof.evaluations))
        assert all(torch.equal(w, words(j)) for w, j in zip(proof.witnesses, jproof.witnesses))
    # a broadcast int differs from the lanes' own challenges beyond lane 0
    assert torch.equal(reads[2].z[0], reads[0].z[0]) and not torch.equal(reads[2].z, reads[0].z)


def test_tampered_instance_moves_its_lane_only(lanes):
    ours, _ = lanes
    plan = _plan(ours)
    inst, sc, pts = _streams(ours)
    _, chals = kd.read(plan.keccak, inst, sc, pts)
    clean = [Snark.load(str(FIXTURES / f"evmsnark_{i:02d}.json")) for i in range(B)]
    _, chals0 = kd.read(plan.keccak, *_streams(clean))
    diff = (chals != chals0).any(-1)  # (n_sq, B)
    assert bool(diff[:, 1].all()) and not bool(diff[:, [0, 2]].any())


def test_gwc_keccak_read_matches_oracle():
    from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
    from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, prove
    from snark_verifier_tpu.transcript import EvmTranscriptPy as JEvmTranscriptPy

    srs_j = j_toy_srs(32)
    snarks = []
    for seed in (21, 22):
        circ = StandardPlonk.rand(k=3, seed=seed)
        protocol = build_protocol(circ, srs_j)
        scalars, points = prove(circ, protocol, srs_j, scheme="gwc",
                                transcript=JEvmTranscriptPy())
        snarks.append(Snark.from_json(JSnark(protocol, [list(circ.instance)], scalars,
                                             points).to_json()))
    snarks[1].protocol = snarks[0].protocol  # one protocol: the circuits share it
    plan = _plan(snarks, "gwc")
    inst, sc, pts = _streams(snarks)
    _, chals = kd.read(plan.keccak, inst, sc, pts)
    assert _ints(chals) == _oracle(snarks, Gwc19)


def test_read_kernel_body_matches_read_plain(lanes, tmp_path):
    from test_torch_keccak_schedule import read_kernel

    ours, _ = lanes
    plan = _plan(ours)
    inst, sc, pts = _streams(ours)
    hp, cp = kd.read_plain(plan.keccak, inst, sc, pts)
    h, c = read_kernel(tmp_path)(plan.keccak, inst, sc, pts)
    assert torch.equal(h, hp) and torch.equal(c, cp)
