"""The port's single-card batch verify (parallel/batch_verify.py on
device="cpu": the succinct phase through the recorded Fr plan, then the
pairing decide, every kernel's plain version) against the JAX package's
python-int verify_snark_native, lane by lane, on the committed
vanilla-PLONK k=10 fixtures: a batch with a tampered instance, and one
with a proof scalar moved by one and a valid on-curve proof point taken
from another proof.

Tolerance: exact (accept bits)."""

from pathlib import Path

import pytest
import torch

from snark_verifier_tpu.ff import FR as JFR
from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.srs import load_params as j_load_params
from snark_verifier_tpu.verifier.plonk.verifier import verify_snark_native
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params

FIXTURES = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"
NAMES = ["snark_00.json", "snark_01.json", "snark_02.json"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tampered(snark_cls, s):
    t = snark_cls(s.protocol, [list(c) for c in s.instances], s.scalars, s.points)
    t.instances[0][0] = (t.instances[0][0] + 1) % JFR.p
    return t


@pytest.fixture(scope="module")
def run():
    """One CPU batch of three proofs, lane 0's first instance moved by one."""
    srs = load_params(str(FIXTURES / "srs.bin"))
    snarks = [Snark.load(str(FIXTURES / n)) for n in NAMES]
    snarks[0] = _tampered(Snark, snarks[0])
    timings = {}
    oks = batch_verify(snarks, srs, device="cpu", timings=timings)
    return oks, timings


def test_batch_verify_cpu_matches_jax_native(run):
    oks, timings = run
    assert oks.dtype == torch.bool and oks.shape == (3,)
    j_srs = j_load_params(str(FIXTURES / "srs.bin"))
    snarks = [JSnark.load(str(FIXTURES / n)) for n in NAMES]
    snarks[0] = _tampered(JSnark, snarks[0])
    want = [verify_snark_native(s, j_srs) for s in snarks]
    assert want == [False, True, True]
    assert oks.tolist() == want
    assert set(timings) == {"succinct_s", "decide_s", "stack_s", "plan_s", "read_s", "gather_s",
                            "fr_tape_s", "msm_s"} and min(timings.values()) > 0


def _tampered_proofs(snark_cls):
    """[a proof scalar + 1, the first proof point swapped for another
    proof's (valid, on the curve), two valid proofs]."""
    s0, s1, s2, s3 = (snark_cls.load(str(FIXTURES / f"snark_{i:02d}.json")) for i in (4, 5, 6, 7))
    bumped = snark_cls(s0.protocol, s0.instances, [(s0.scalars[0] + 1) % JFR.p] + s0.scalars[1:],
                       s0.points)
    swapped = snark_cls(s1.protocol, s1.instances, s1.scalars, [s2.points[0]] + s1.points[1:])
    return [bumped, swapped, s2, s3]


def test_tampered_scalar_and_swapped_point_match_jax_native():
    srs = load_params(str(FIXTURES / "srs.bin"))
    oks = batch_verify(_tampered_proofs(Snark), srs, device="cpu")
    j_srs = j_load_params(str(FIXTURES / "srs.bin"))
    want = [verify_snark_native(s, j_srs) for s in _tampered_proofs(JSnark)]
    assert want == [False, False, True, True]
    assert oks.tolist() == want


def test_batch_verify_rejects_unsupported_pairs():
    srs = load_params(str(FIXTURES / "srs.bin"))
    s = Snark.load(str(FIXTURES / NAMES[0]))
    for scheme, transcript in (("gwc", "blake2b"), ("shplonk", "blake2b")):
        with pytest.raises(ValueError):
            batch_verify([s], srs, scheme, transcript, device="cpu")
