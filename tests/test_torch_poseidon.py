"""Port Poseidon (hash/poseidon.py: permute on CPU tensors, i.e. the plain
twin of svt_poseidon_permute, the batched sponge and the python oracle) and
the Poseidon transcript (transcript/poseidon_transcript.py) vs the JAX
package's hash/poseidon.py and transcript/poseidon_transcript.py, on the
same numpy-seeded inputs, plus the hadeshash x5_254_3 vector.

Tolerance: exact.  The permutation matches the JAX scan limb for limb on
lazy [0, 2r] inputs; challenges compare as canonical ints."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ff import FR_FIELD as JFR
from snark_verifier_tpu.hash import poseidon as jpos
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.transcript import PoseidonTranscriptPy as JTranscriptPy
from snark_verifier_tpu_torch.ec import from_affine_int_np, py_ec
from snark_verifier_tpu_torch.ff import FQ, FQW, FR, FRW, limbs_to_words, words_to_limbs
from snark_verifier_tpu_torch.hash import PoseidonPy, PoseidonSponge, get_spec, permute
from snark_verifier_tpu_torch.transcript import PoseidonTranscript, PoseidonTranscriptPy, fq_to_fr

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"

# hadeshash poseidonperm_x5_254_3 (reference poseidon/tests.rs:50-54)
PERM_X5_254_3 = [
    7853200120776062878684798364095072458815029376092732009249414926327459813530,
    7142104613055408817911962100316808866448378443474503659992478482890339429929,
    6549537674122432311777789598043107870002137484850126429160507761192163713804,
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match_jax():
    assert get_spec() == jpos.get_spec(3, 8, 57)


def test_permute_matches_jax_on_lazy_states():
    rng = np.random.default_rng(21)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FR.p + 1) for _ in range(4 * 3)]
    vals[:3] = [0, FR.p, 2 * FR.p]  # lazy edge representatives
    limbs = np.asarray([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals],
                       dtype=np.uint32).reshape(4, 3, 16)
    got = permute(limbs_to_words(torch.from_numpy(limbs.astype(np.int64))))
    want = np.asarray(jpos.permute(jnp.asarray(limbs)))
    assert np.array_equal(words_to_limbs(got).numpy(), want.astype(np.int64))


def test_permutation_kat_t3():
    h = PoseidonPy()
    h.state = [0, 1, 2]
    h.permutation([0, 0])
    assert h.state == PERM_X5_254_3
    out = permute(FRW.from_int([0, 1, 2]).view(1, 3, 8))
    assert list(FRW.to_int(out[0])) == PERM_X5_254_3


@pytest.mark.parametrize("seqs", [[[]], [[5, 6, 7], [8]], [[1, 2], [3, 4, 5, 6]]])
def test_sponge_matches_jax_and_oracle(seqs):
    rng = np.random.default_rng(len(seqs))
    port = PoseidonSponge(2, "cpu")
    jax_sp = jpos.PoseidonJax(batch_shape=(2,))
    oracle = [PoseidonPy(), PoseidonPy()]
    for seq in seqs:
        lanes = [[(v * 7919 + int(rng.integers(0, 1 << 30))) % FR.p for v in seq]
                 for _ in range(2)]
        port.update([FRW.from_int([lanes[0][i], lanes[1][i]]) for i in range(len(seq))])
        jax_sp.update([JFR.from_int([lanes[0][i], lanes[1][i]]) for i in range(len(seq))])
        for o, lane in zip(oracle, lanes):
            o.update(lane)
        got = port.squeeze()
        want = np.asarray(jax_sp.squeeze())
        assert np.array_equal(words_to_limbs(got).numpy(), want.astype(np.int64))
        assert list(FRW.to_int(got)) == [o.squeeze() for o in oracle]


def test_fq_to_fr_reduces_mod_r():
    vals = [FQ.p - 1, FR.p, FR.p - 1, 0, 12345]
    got = FRW.to_int(fq_to_fr(FQW.from_int(vals)))
    assert list(got) == [v % FR.p for v in vals]


def test_transcript_matches_jax_oracle_over_a_fixture_stream():
    """The port's batched transcript (two lanes: the fixture and a shifted
    copy) and the port's oracle walk a fixture's streams as the verifier
    does; the JAX package's python transcript gives the same challenges."""
    snark = JSnark.load(str(FIXTURES / "snark_03.json"))
    pts, scs = snark.points[:6], snark.scalars[:5]
    lanes = [(pts, scs), (pts[1:] + pts[:1], scs[1:] + scs[:1])]
    sc = torch.stack([FRW.from_int(s) for _, s in lanes], 0)
    pt = torch.from_numpy(np.stack([from_affine_int_np(p)[:, :2] for p, _ in lanes], 0))
    td = PoseidonTranscript(sc.contiguous(), pt.contiguous(), "cpu")

    def walk(t, challenge):
        out = []
        t.common_scalar(challenge(snark.instances[0][0]))
        t.read_n_ec_points(3)
        out.append(t.squeeze_challenge())
        t.read_n_scalars(3)
        out.append(t.squeeze_challenge())
        t.read_ec_point()
        t.read_n_scalars(2)
        t.read_n_ec_points(2)
        out.append(t.squeeze_challenge())
        out.append(t.squeeze_challenge())
        return out

    got = walk(td, lambda v: FRW.from_int(v))
    for lane, (p, s) in enumerate(lanes):
        want = walk(JTranscriptPy(scalars=s, points=p), lambda v: v)
        ours = walk(PoseidonTranscriptPy(scalars=s, points=p), lambda v: v)
        assert [int(FRW.to_int(c[lane])) for c in got] == want == ours


def test_oracle_transcript_rejects_the_identity():
    from snark_verifier_tpu_torch.errors import TranscriptError

    t = PoseidonTranscriptPy(points=[None])
    with pytest.raises(TranscriptError):
        t.read_ec_point()
    t = PoseidonTranscriptPy(points=py_ec.rand_points(1, seed=2))
    t.read_ec_point()
