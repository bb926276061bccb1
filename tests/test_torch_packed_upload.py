"""A batch's inputs packed into one host block and sent as one upload
(`sdk/aggregation.py::_pack_inputs`, `_stack_streams`, `_instance_block`)
on the CPU, held word for word to a python-int copy of the per-lane
conversion: a scalar s is the Fr word s·R mod p, a point coordinate c the
Fq word c·R mod q, an instance v the Fr word (v mod p)·R mod p, or v mod p
for the plain words of an instance commitment (R = 2^256).

Shapes: the benchmark pool's StandardPlonk proofs (1 instance, 20
scalars, 11 points), the 12-instance old-accumulator fixture
(`fixtures/old_acc_valid.json`) and an instance-committing stub protocol
(two columns), at B = 1 and B = 1,024, with drawn values that include 0,
p - 1 and values at and above p.  Every view of the packed block is
contiguous and starts on a 32-byte boundary of it; on the CPU the block
is plain memory and the upload is the block itself.  A packed batch is
one count of `packed_uploads` and no host wait.

Tolerance: exact (int32 words, counts)."""

import gc
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch import _launch
from snark_verifier_tpu_torch.ec import py_ec
from snark_verifier_tpu_torch.ff.spec import FQ, FR
from snark_verifier_tpu_torch.sdk import aggregation as agg
from snark_verifier_tpu_torch.sdk.snark import Snark

CPU = torch.device("cpu")
P = FR.p
R = 1 << 256
FIXTURES = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "fixtures"
EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1, R - 1]  # values at and above p reduce first


def _words(x: int) -> np.ndarray:
    """A python int in [0, 2^256) -> its 8 little-endian 32-bit words as int32."""
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)], np.uint32).view(np.int32)


def _inst_ref(snarks, mont: bool) -> np.ndarray:
    """(B, n_inst, 8): each lane's instances, column by column, one value at
    a time."""
    return np.stack([np.stack([_words((v % P) * (R if mont else 1) % P)
                               for col in s.instances for v in col])
                     for s in snarks])


def _streams_ref(snarks):
    sc = np.stack([np.stack([_words(x * R % P) for x in s.scalars]) for s in snarks])
    pts = np.stack([np.stack([np.stack([_words(x * R % FQ.p), _words(y * R % FQ.p)])
                              for x, y in s.points]) for s in snarks])
    return sc, pts


def _proto(num_instance, ick=None):
    return SimpleNamespace(num_instance=list(num_instance), accumulator_indices=[],
                           instance_committing_key=ick)


_CURVE = [py_ec.scalar_mul(py_ec.G1_GEN, k + 2) for k in range(16)]


def _pool_snarks(B, num_instance, seed, ick=None, n_scalars=20, n_points=11):
    """B distinct proofs of the pool's stream shape with drawn reduced
    values (0 and p - 1 among them): every lane its own object, so every
    lane's streams are converted."""
    rng = random.Random(seed)
    proto = _proto(num_instance, ick)
    draw = lambda: rng.choice([0, P - 1, rng.randrange(P)])
    return [Snark(proto, [[draw() for _ in range(n)] for n in num_instance],
                  [draw() for _ in range(n_scalars)],
                  [rng.choice(_CURVE) for _ in range(n_points)]) for _ in range(B)]


def _check_views(block_views):
    base = block_views[0].data_ptr()
    end = base
    for v in block_views:
        assert v.is_contiguous() and v.dtype == torch.int32 and v.device == CPU
        assert (v.data_ptr() - base) % 32 == 0 and v.data_ptr() == end  # back to back
        end = v.data_ptr() + 4 * v.numel()
    assert len({v.untyped_storage().data_ptr() for v in block_views}) == 1  # one block


@pytest.mark.parametrize("B", [1, 1024])
def test_the_pools_shape_packs_word_for_word(B):
    snarks = _pool_snarks(B, [1], seed=B)
    _launch.reset_launches()
    views = agg._pack_inputs(snarks, CPU, plain=False)
    assert _launch.COUNTERS["packed_uploads"] == 1 and _launch.COUNTERS["host_waits"] == 0
    sc, pts, inst = views
    assert sc.shape == (B, 20, 8) and pts.shape == (B, 11, 2, 8) and inst.shape == (B, 1, 8)
    _check_views(views)
    want_sc, want_pts = _streams_ref(snarks)
    assert np.array_equal(sc.numpy(), want_sc) and np.array_equal(pts.numpy(), want_pts)
    assert np.array_equal(inst.numpy(), _inst_ref(snarks, True))
    assert not sc.is_pinned()  # the CPU block is plain memory


@pytest.mark.parametrize("B", [1, 1024])
def test_the_old_accumulator_fixture_packs_word_for_word(B):
    snark = Snark.load(str(FIXTURES / "old_acc_valid.json"))
    assert snark.protocol.num_instance == [12]
    snarks = [snark] * B
    views = agg._pack_inputs(snarks, CPU, plain=False)
    _check_views(views)
    want_sc, want_pts = _streams_ref(snarks)
    assert np.array_equal(views[0].numpy(), want_sc)
    assert np.array_equal(views[1].numpy(), want_pts)
    assert np.array_equal(views[2].numpy(), _inst_ref(snarks, True))
    # drawn values of the same 12-instance shape, at and above p too
    rng = random.Random(B)
    drawn = [Snark(snark.protocol, [[rng.choice(EDGES + [rng.randrange(R)]) for _ in range(12)]],
                   snark.scalars, snark.points) for _ in range(B)]
    for mont in (True, False):
        got = agg._instance_block(drawn, CPU, mont)
        assert got.shape == (B, 12, 8) and np.array_equal(got.numpy(), _inst_ref(drawn, mont))


class _Columns(list):
    """Instance columns that count the walks over them."""

    walks = 0

    def __iter__(self):
        _Columns.walks += 1
        return super().__iter__()


@pytest.mark.parametrize("B", [1, 1024])
def test_an_instance_committing_batch_packs_both_blocks_from_one_walk(B):
    ick = {"bases": [py_ec.G1_GEN] * 3, "constant": None}
    snarks = _pool_snarks(B, [2, 3], seed=7 + B, ick=ick, n_scalars=4, n_points=3)
    for s in snarks:
        s.host_streams()
        s.instances = _Columns(s.instances)
    _Columns.walks = 0
    _launch.reset_launches()
    views = agg._pack_inputs(snarks, CPU, plain=True)
    assert _Columns.walks == B  # each lane's columns walked once for both blocks
    assert _launch.COUNTERS["packed_uploads"] == 1 and _launch.COUNTERS["host_waits"] == 0
    sc, pts, inst, plain = views
    _check_views(views)
    assert inst.shape == plain.shape == (B, 5, 8)
    assert np.array_equal(inst.numpy(), _inst_ref(snarks, True))
    assert np.array_equal(plain.numpy(), _inst_ref(snarks, False))
    assert np.array_equal(sc.numpy(), _streams_ref(snarks)[0])


@pytest.mark.parametrize("B", [1, 1024])
@pytest.mark.parametrize("mont", [True, False])
def test_instance_words_equal_the_per_value_conversion_at_and_above_p(B, mont):
    rng = random.Random(B + mont)
    proto = _proto([2, 1])
    vals = EDGES + [rng.randrange(R) for _ in range(3 * B)]
    snarks = [Snark(proto, [vals[3 * b:3 * b + 2], vals[3 * b + 2:3 * b + 3]], [], [])
              for b in range(B)]
    got = agg._instance_block(snarks, CPU, mont)
    assert got.is_contiguous() and np.array_equal(got.numpy(), _inst_ref(snarks, mont))
    if mont:
        cols = agg._stack_instances(snarks, CPU)
        assert [len(c) for c in cols] == [2, 1]
        assert np.array_equal(cols[1][0].numpy(), _inst_ref(snarks, True)[:, 2])


def test_the_standalone_stacks_keep_their_contract():
    snarks = _pool_snarks(3, [1], seed=3)
    sc, pts = agg._stack_streams(snarks, CPU)
    want_sc, want_pts = _streams_ref(snarks)
    assert np.array_equal(sc.numpy(), want_sc) and np.array_equal(pts.numpy(), want_pts)
    assert sc.is_contiguous() and pts.is_contiguous()
    _launch.reset_launches()
    for _ in range(2):
        agg._pack_inputs(snarks, CPU, plain=False)
    assert _launch.COUNTERS["packed_uploads"] == 2 and _launch.COUNTERS["host_waits"] == 0


def test_lanes_of_other_shapes_are_refused():
    snarks = _pool_snarks(2, [1], seed=5)
    short = Snark(snarks[0].protocol, snarks[0].instances, snarks[0].scalars[:-1],
                  snarks[0].points)
    with pytest.raises(ValueError, match="differ in shape"):
        agg._stack_streams([snarks[0], short], CPU)
    few = Snark(snarks[0].protocol, [[]], [], [])
    with pytest.raises(ValueError, match="instance values"):
        agg._instance_block([snarks[0], few], CPU)


def test_a_packed_batch_starts_no_collection():
    """Packing 1,024 lanes holds no more than a handful of GC-tracked
    objects at once, so it never starts a collector pass of its own (a
    full pass over a server's heap takes 100 ms and more)."""
    snarks = _pool_snarks(1024, [1], seed=11)
    agg._pack_inputs(snarks, CPU, plain=False)
    passes = []
    gc.collect()
    gc.callbacks.append(lambda phase, info: phase == "start" and passes.append(info))
    try:
        for _ in range(3):
            agg._pack_inputs(snarks, CPU, plain=False)
    finally:
        gc.callbacks.pop()
    assert passes == []
