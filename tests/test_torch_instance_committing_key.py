"""The query-instance protocol family (an instance committing key) in the
port: `PlonkProof.read` commits to each instance column, Σ bases·instances
(+ the key's constant point), and absorbs the point instead of the
instances.  The JAX package's stub protocol of
tests/test_instance_committing_key.py (a protocol that stops before the
PCS), widened to several lanes, columns and edge cases, is read three ways
in the port -- the python-int `NATIVE` loader, the eager `TorchLoader` and
the plan's pre-read commitment (`verifier/plonk/plan.py::commit_instances`,
one `msm_windowed` for the whole batch, then `read_proof` absorbing it as a
lane point) -- and held to the JAX package's NATIVE and DEVICE reads: the
committed point, the constant term, the challenge z the read squeezes and
the squeeze after it.

Tolerance: exact (affine python ints, canonical challenges)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ec import to_affine_int as j_to_affine_int
from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.loader.base import NATIVE as JNATIVE
from snark_verifier_tpu.transcript import PoseidonTranscript as JPoseidonTranscript
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JPoseidonTranscriptPy
from snark_verifier_tpu.verifier.plonk.verifier import PlonkProof as JPlonkProof
from snark_verifier_tpu_torch import errors
from snark_verifier_tpu_torch.ec import py_ec, to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.ff import FR, FRW, int_to_limbs, limbs_to_words
from snark_verifier_tpu_torch.loader.base import NATIVE, TorchLoader
from snark_verifier_tpu_torch.loader.tape_loader import TapeLoader, TapeTranscript
from snark_verifier_tpu_torch.transcript import PoseidonTranscript, PoseidonTranscriptPy
from snark_verifier_tpu_torch.verifier.plonk import plan as vplan
from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkProof

R = FR.p
CPU = torch.device("cpu")


class _Proto:
    """The JAX package's stub (tests/test_instance_committing_key.py), with
    its columns' sizes free: just what PlonkProof.read touches before the
    PCS."""

    def __init__(self, bases, constant=None, num_instance=None):
        self.transcript_initial_state = 7
        self.num_instance = [len(bases)] if num_instance is None else list(num_instance)
        self.num_witness = []
        self.num_challenge = []
        self.evaluations = []
        self.queries = []
        self.accumulator_indices = []
        self.instance_committing_key = {"bases": bases, "constant": constant}

        class _Q:
            @staticmethod
            def num_chunk():
                return 0

        self.quotient = _Q()

    class domain:
        @staticmethod
        def rotate(r):
            return 1


class _NullPcs:
    @staticmethod
    def read_proof(queries, transcript):
        return {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _case(name):
    """(protocol, instances of two lanes)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "three bases":
        return _Proto(py_ec.rand_points(3, seed=1)), [[[5, 7, 11]], [_rand(rng, 3)]]
    if name == "constant":
        proto = _Proto(py_ec.rand_points(2, seed=2), py_ec.rand_points(1, seed=3)[0])
        return proto, [[[3, 4]], [_rand(rng, 2)]]
    if name == "two columns":
        proto = _Proto(py_ec.rand_points(3, seed=4), py_ec.rand_points(1, seed=5)[0], [3, 2])
        return proto, [[_rand(rng, 3), _rand(rng, 2)] for _ in range(2)]
    if name == "an empty column, constant":
        proto = _Proto(py_ec.rand_points(1, seed=6), py_ec.rand_points(1, seed=7)[0], [1, 0])
        return proto, [[_rand(rng, 1), []] for _ in range(2)]
    # a column with no value and no constant: its commitment is the identity
    proto = _Proto(py_ec.rand_points(2, seed=8), None, [0])
    return proto, [[[]], [[]]]


CASES = ["three bases", "constant", "two columns", "an empty column, constant",
         "an empty column, no constant"]
# The JAX package's eager DEVICE read costs 5-15 s a call on XLA:CPU: it reads
# lane 0 of these two cases (two columns, one empty, and a constant; an
# identity commitment).
DEVICE = ("an empty column, constant", "an empty column, no constant")


def _want_point(proto, cols):
    ick = proto.instance_committing_key
    out = []
    for col in cols:
        pt = py_ec.msm(ick["bases"][: len(col)], col)
        out.append(py_ec.add(pt, ick["constant"]) if ick["constant"] is not None else pt)
    return out


def _jax_device(proto, cols):
    """The JAX package's DEVICE read of one lane -> (points, z, next squeeze)."""
    td = JPoseidonTranscript(scalars=jnp.zeros((0, 16), "uint32"),
                             points=jnp.zeros((0, 2, 16), "uint32"))
    pd = JPlonkProof.read(proto, [[JFR.from_int(v) for v in col] for col in cols], td, _NullPcs)
    pts = [j_to_affine_int(p) for p in pd.committed_instances]
    return pts, int(JFR.to_int(pd.z)), int(JFR.to_int(td.squeeze_challenge()))


def _words(vals, mont):
    """python ints -> (n, 8) words: Montgomery or canonical plain."""
    f = (lambda v: v % R * (1 << 256) % R) if mont else (lambda v: v % R)
    if not vals:
        return torch.zeros((0, 8), dtype=torch.int32)
    return limbs_to_words(torch.as_tensor(np.stack([int_to_limbs(f(v)) for v in vals])
                                          .astype(np.int64)))


def _empty_streams(B):
    return (torch.zeros((B, 0, 8), dtype=torch.int32),
            torch.zeros((B, 0, 2, 8), dtype=torch.int32))


def _port_reads(proto, lanes_cols):
    """The port's eager TorchLoader read and the plan's pre-read commitment
    over a batch -> {way: (points per lane, z per lane, next per lane)}."""
    B = len(lanes_cols)
    flat = [[v for col in cols for v in col] for cols in lanes_cols]
    mont = torch.stack([_words(f, True) for f in flat], 0)  # (B, n_inst, 8)
    plain = torch.stack([_words(f, False) for f in flat], 0)
    cols = []
    k = 0
    for n in proto.num_instance:
        cols.append([mont[:, k + i] for i in range(n)])
        k += n
    out = {}

    # eager TorchLoader
    sc, pts = _empty_streams(B)
    tr = PoseidonTranscript(sc, pts, CPU)
    proof = PlonkProof.read(proto, cols, tr, _NullPcs, TorchLoader(B, CPU))
    got = [to_affine_int(words_to_limbs(p)) for p in proof.committed_instances]  # per column
    out["torch"] = ([[got[c][b] for c in range(len(got))] for b in range(B)],
                    FRW.to_int(proof.z), FRW.to_int(tr.squeeze_challenge()))

    # the plan's commitment before the read, absorbed as lane points
    lanes = vplan.commit_instances(proto, plain)
    tr = PoseidonTranscript(sc, pts, CPU, lanes=lanes)
    reads = vplan.read_proof(proto, _NullPcs, cols, tr, TorchLoader(B, CPU))
    got = [to_affine_int(words_to_limbs(lanes[b])) for b in range(B)]
    out["plan"] = (got, FRW.to_int(reads.values[0]), FRW.to_int(tr.squeeze_challenge()))
    return out


@pytest.mark.parametrize("name", CASES)
def test_ick_read_matches_jax_native_and_device(name):
    proto, lanes_cols = _case(name)
    port = _port_reads(proto, lanes_cols)
    for b, cols in enumerate(lanes_cols):
        want = _want_point(proto, cols)
        if all(p is not None for p in want):
            # NATIVE: the JAX package's and the port's python-int reads
            jt, pt = JPoseidonTranscriptPy(), PoseidonTranscriptPy()
            jproof = JPlonkProof.read(proto, cols, jt, _NullPcs, L=JNATIVE)
            proof = PlonkProof.read(proto, cols, pt, _NullPcs, NATIVE)
            assert jproof.committed_instances == proof.committed_instances == want
            assert jproof.z == proof.z
            jz_next, z_next = jt.squeeze_challenge(), pt.squeeze_challenge()
            assert jz_next == z_next
        else:
            # the identity has no affine form in the python-int transcripts
            with pytest.raises(errors.TranscriptError):
                PlonkProof.read(proto, cols, PoseidonTranscriptPy(), _NullPcs, NATIVE)
        if b == 0 and name in DEVICE:  # the JAX package's eager device read
            jpts, jz, jnext = _jax_device(proto, cols)
            assert jpts == want
            for way, (pts, zs, nexts) in port.items():
                assert pts[0] == want, way
                assert int(zs[0]) == jz and int(nexts[0]) == jnext, way
            if all(p is not None for p in want):
                assert jz == proof.z and jnext == z_next
        for way, (pts, zs, nexts) in port.items():
            assert pts[b] == want, (way, b)
    # the two port reads agree lane for lane
    assert list(port["torch"][1]) == list(port["plan"][1])
    assert list(port["torch"][2]) == list(port["plan"][2])


def test_ick_recording_makes_lane_points():
    """Under the recorder the commitment is a lane point of instance inputs
    times protocol points; the transcript keeps it as ("lane", c)."""
    proto, _ = _case("two columns")
    L = TapeLoader()
    inst = [[L.input(vplan.instance_label(c, i)) for i in range(n)]
            for c, n in enumerate(proto.num_instance)]
    tr = TapeTranscript(L)
    proof = PlonkProof.read(proto, inst, tr, _NullPcs, L)
    assert [p.index for p in proof.committed_instances] == [0, 1]
    assert [c.scaled for c in L.lane_points] == [[(0, 0), (1, 1), (2, 2)], [(3, 0), (4, 1)]]
    assert [len(c.plain) for c in L.lane_points] == [1, 1]
    assert tr.squeezes == [[("const", 7), ("lane", 0), ("lane", 1)]]
    with pytest.raises(errors.InvalidProtocol):
        vplan.keccak_schedule(tr.squeezes, proto)


def test_ick_plan_through_the_linearization_matches_native():
    """A whole ick verify through the recorded plan: a StandardPlonk k = 3
    snark from the JAX package's host prover, its protocol given an
    instance committing key, its instance column queried by the PCS and
    evaluated in the proof (an extra stream scalar), so that the committed
    point enters the SHPLONK MSM as a lane base.  No prover makes such a
    proof, so the accumulator is no valid one: the plan's (batch of 2, CPU)
    must equal the port's python-int verifier's, which moves with the key's
    constant.  The keccak plan of such a protocol is refused."""
    import json
    import copy

    from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
    from snark_verifier_tpu.system.standard_plonk import StandardPlonk, build_protocol, gen_snark
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import toy_srs
    from snark_verifier_tpu_torch.verifier.plonk.protocol import Query
    from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkSuccinctVerifier

    srs_j = j_toy_srs(32)
    circ = StandardPlonk.rand(k=3, seed=1)
    js = gen_snark(circ, build_protocol(circ, srs_j), srs_j, scheme="shplonk")
    s = Snark.from_json(json.loads(json.dumps(js.to_json())))
    p = s.protocol
    iq = Query(len(p.preprocessed), 0)
    p.instance_committing_key = {"bases": py_ec.rand_points(p.num_instance[0], seed=5),
                                 "constant": py_ec.rand_points(1, seed=6)[0]}
    s.scalars.insert(len(p.evaluations), 12345)
    p.evaluations.append(iq)
    p.queries.append(iq)
    srs = toy_srs(32)

    def native(protocol):
        inst = [[v % R for v in c] for c in s.instances]
        t = PoseidonTranscriptPy(scalars=s.scalars, points=s.points)
        proof = PlonkProof.read(protocol, inst, t, Bdfg21, NATIVE)
        return PlonkSuccinctVerifier.verify(srs.g, protocol, inst, proof, Bdfg21, NATIVE)

    want = native(p)
    got = batch_succinct_verify([s, s], srs, device="cpu")
    assert [list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
            for lhs, rhs in got] == [[want[0]] * 2]
    moved = copy.deepcopy(p)
    moved.instance_committing_key["constant"] = py_ec.rand_points(1, seed=7)[0]
    assert native(moved) != want
    with pytest.raises(errors.InvalidProtocol):
        batch_succinct_verify([s], srs, transcript="evm", device="cpu")
