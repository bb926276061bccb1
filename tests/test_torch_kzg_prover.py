"""The port's host KZG openers (`pcs/kzg/prover_py.py`: `gwc_open`,
`shplonk_open`) against the JAX package's on `toy_srs(32)`: numpy-seeded
polynomials of up to 20 coefficients, queried at shifts 1, ω and ω⁻¹
(one, two and three polynomials a shift set), written over a Poseidon and
a keccak transcript with `device="cpu"`: the streams and the challenges
equal the JAX package's.  A query whose eval is off by one makes SHPLONK
raise.

Tolerance: exact (python ints)."""

import numpy as np
import pytest

from snark_verifier_tpu.pcs.kzg.multiopen import Query as JQuery
from snark_verifier_tpu.pcs.kzg.prover_py import gwc_open as j_gwc, shplonk_open as j_shplonk
from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs
from snark_verifier_tpu.transcript.evm_transcript import EvmTranscriptPy as JEvm
from snark_verifier_tpu.transcript.poseidon_transcript import PoseidonTranscriptPy as JPos
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Query
from snark_verifier_tpu_torch.pcs.kzg.prover_py import gwc_open, shplonk_open
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.transcript import EvmTranscriptPy, PoseidonTranscriptPy
from snark_verifier_tpu_torch.utils.py_poly import peval
from snark_verifier_tpu_torch.verifier.plonk.protocol import Domain

R = FR.p
W = Domain.bn254(3).gen


def _case(seed):
    rng = np.random.default_rng(seed)
    rand = lambda n: [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    polys = [rand(int(rng.integers(1, 21))) for _ in range(4)]
    z = rand(1)[0]
    shifts = [(0, 1), (1, 1), (2, 1), (0, W), (3, W), (2, pow(W, -1, R))]
    queries = [(p, sh, peval(polys[p], z * sh % R)) for p, sh in shifts]
    return polys, queries, z


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
@pytest.mark.parametrize("transcript", ["poseidon", "evm"])
def test_openers_match_jax(seed, scheme, transcript):
    polys, queries, z = _case(seed)
    ours = {"gwc": gwc_open, "shplonk": shplonk_open}[scheme]
    theirs = {"gwc": j_gwc, "shplonk": j_shplonk}[scheme]
    t = {"poseidon": PoseidonTranscriptPy, "evm": EvmTranscriptPy}[transcript]()
    jt = {"poseidon": JPos, "evm": JEvm}[transcript]()
    t.common_scalar(z)
    jt.common_scalar(z)
    ours(toy_srs(32), polys, [Query(*q) for q in queries], z, t, device="cpu")
    theirs(j_toy_srs(32), polys, [JQuery(*q) for q in queries], z, jt)
    assert t.streams() == jt.streams()
    assert t.squeeze_challenge() == jt.squeeze_challenge()


def test_shplonk_refuses_a_wrong_eval():
    polys, queries, z = _case(3)
    p, sh, ev = queries[1]
    queries[1] = (p, sh, (ev + 1) % R)
    with pytest.raises(ValueError):
        shplonk_open(toy_srs(32), polys, [Query(*q) for q in queries], z,
                     PoseidonTranscriptPy(), device="cpu")
