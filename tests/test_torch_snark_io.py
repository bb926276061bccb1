"""The port's `Snark` writer and dummy snarks (`sdk/snark.py`) against the
JAX package's: `to_json` of a committed vanilla_k10 fixture (each
transcript family) equals the JAX package's, key for key, and equals the
file it was read from; `save` writes JSON that both packages' `load` read
back to the same snark; `gen_dummy_snark` equals the JAX package's for
SHPLONK and GWC19 at two seeds, with `proof_shape`'s stream lengths, and
it passes `validate` (its points are on the curve, its scalars reduced).

Tolerance: exact (JSON of python ints)."""

import json
from pathlib import Path

import pytest

from snark_verifier_tpu.sdk.snark import Snark as JSnark
from snark_verifier_tpu.sdk.snark import gen_dummy_snark as j_dummy
from snark_verifier_tpu_torch.sdk.snark import Snark, gen_dummy_snark, proof_shape

FIX = Path(__file__).resolve().parent.parent / "benchmarks" / "fixtures" / "vanilla_k10"


@pytest.mark.parametrize("name", ["snark_00.json", "gwcsnark_01.json", "evmsnark_02.json"])
def test_to_json_save_load_match_jax(tmp_path, name):
    on_disk = json.loads((FIX / name).read_text())
    sn, jsn = Snark.load(str(FIX / name)), JSnark.load(str(FIX / name))
    assert sn.to_json() == jsn.to_json() == on_disk
    sn.save(str(tmp_path / "port.json"))
    jsn.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert JSnark.load(str(tmp_path / "port.json")).to_json() == on_disk
    assert Snark.load(str(tmp_path / "port.json")).to_json() == on_disk


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
@pytest.mark.parametrize("seed", [0, 5])
def test_dummy_snark_matches_jax(scheme, seed):
    protocol = Snark.load(str(FIX / "snark_00.json")).protocol
    jprotocol = JSnark.load(str(FIX / "snark_00.json")).protocol
    sn = gen_dummy_snark(protocol, scheme, seed=seed)
    assert sn.to_json() == j_dummy(jprotocol, scheme, seed=seed).to_json()
    assert (len(sn.scalars), len(sn.points)) == proof_shape(protocol, scheme)
    sn.validate()
