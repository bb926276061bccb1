"""The port's warm-start cache (`sdk/aot.py`) in a temporary
`SNARK_AOT_DIR`: a digest stable across two processes and changed by a
changed source in a copy of the package; recorded plans (SHPLONK with
Poseidon, the keccak read's schedule, GWC19 with an instance-encoded old
accumulator, the IPA plan) and the SRS's G2 lines saved, then loaded in
place of a fresh recording, equal to it field for field and in the
`run_plain` output of their tapes; a corrupt or undecodable entry deleted
and recorded again; `_prune` under `SNARK_AOT_MAX_BYTES`; `SNARK_AOT=0`
and the default (on for a CUDA device only).

Tolerance: exact (arrays, labels, tape outputs)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch.ff import fr_tape
from snark_verifier_tpu_torch.pcs.ipa import fixtures as ipa_fixtures
from snark_verifier_tpu_torch.pcs.ipa import plan as ipa_plan_mod
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
from snark_verifier_tpu_torch.sdk import aot
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import Srs, toy_srs
from snark_verifier_tpu_torch.verifier.plonk import plan as plan_mod

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "benchmarks" / "fixtures" / "vanilla_k10"
OLD_ACC = REPO / "snark_verifier_tpu_torch" / "fixtures" / "old_acc_valid.json"


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SNARK_AOT", "1")
    monkeypatch.setenv("SNARK_AOT_DIR", str(tmp_path / "aot"))
    monkeypatch.setattr(plan_mod, "_PLANS", {})
    monkeypatch.setattr(ipa_plan_mod, "_PLANS", {})
    return tmp_path / "aot"


def _digest_in(pythonpath):
    code = "from snark_verifier_tpu_torch.sdk import aot; print(aot.digest(('plan', 1, 'x')))"
    env = dict(os.environ, PYTHONPATH=str(pythonpath))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=str(pythonpath))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_digest_is_stable_and_follows_the_sources(tmp_path):
    first = _digest_in(REPO)
    assert first == _digest_in(REPO) == aot.digest(("plan", 1, "x"))
    assert aot.digest(("plan", 2, "x")) != first
    copy = tmp_path / "copy"
    shutil.copytree(REPO / "snark_verifier_tpu_torch", copy / "snark_verifier_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__", "fixtures"))
    assert _digest_in(copy) == first  # where the package lies does not matter
    with open(copy / "snark_verifier_tpu_torch" / "device.py", "a") as f:
        f.write("\n# a changed source\n")
    changed = _digest_in(copy)
    assert changed != first
    with open(copy / "snark_verifier_tpu_torch" / "csrc" / "fq.cuh", "a") as f:
        f.write("\n// a changed kernel\n")
    assert _digest_in(copy) not in (first, changed)


def _same_plan(a, b):
    for x, y in ((a.tape.rows, b.tape.rows), (a.tape.consts, b.tape.consts)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (a.tape.inputs, a.tape.outputs, a.tape.n_slots) == (
        b.tape.inputs, b.tape.outputs, b.tape.n_slots)
    assert a.const_points == b.const_points and a.n_points == b.n_points
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 1 << 31, size=(len(a.tape.inputs), 2, 8), dtype=np.int64)
    raw[..., 7] &= 0x0FFFFFFF  # < 2^252: lazy words below 2r
    inputs = torch.from_numpy(raw.astype(np.int32))
    assert torch.equal(fr_tape.run_plain(a.tape, inputs), fr_tape.run_plain(b.tape, inputs))


def _entries(cache):
    return sorted(cache.glob("*.npz")) if cache.exists() else []


@pytest.mark.parametrize("prefix,scheme,name,transcript", [
    ("snark", Bdfg21, "shplonk", "poseidon"), ("evmsnark", Bdfg21, "shplonk", "evm")])
def test_plan_saved_then_loaded_equals_a_fresh_recording(cache, prefix, scheme, name, transcript):
    protocol = Snark.load(str(FIXTURES / f"{prefix}_00.json")).protocol
    fresh = plan_mod.succinct_plan(protocol, scheme, name, transcript, device="cpu")
    assert not fresh.from_cache and len(_entries(cache)) == 1
    plan_mod._PLANS.clear()
    loaded = plan_mod.succinct_plan(protocol, scheme, name, transcript, device="cpu")
    assert loaded.from_cache and loaded is not fresh
    _same_plan(fresh, loaded)
    assert loaded.accs == fresh.accs and loaded.n_lanes == fresh.n_lanes
    if transcript == "evm":
        assert loaded.keccak.squeezes == fresh.keccak.squeezes
        assert loaded.keccak.consts == fresh.keccak.consts
    else:
        assert loaded.keccak is None


def test_old_accumulator_and_ipa_plans_round_trip(cache):
    protocol = Snark.load(str(OLD_ACC)).protocol
    fresh = plan_mod.succinct_plan(protocol, Gwc19, "gwc", "poseidon", device="cpu")
    assert any(isinstance(a, plan_mod.LimbRecord) for a in fresh.accs)
    plan_mod._PLANS.clear()
    loaded = plan_mod.succinct_plan(protocol, Gwc19, "gwc", "poseidon", device="cpu")
    assert loaded.from_cache and loaded.accs == fresh.accs
    _same_plan(fresh, loaded)

    svk = ipa_fixtures.ipa_keys()[0].svk
    fresh = ipa_plan_mod.ipa_plan("ipa", svk, device="cpu")
    ipa_plan_mod._PLANS.clear()
    loaded = ipa_plan_mod.ipa_plan("ipa", svk, device="cpu")
    assert loaded.from_cache and not fresh.from_cache
    _same_plan(fresh, loaded)
    assert (loaded.check, loaded.xi_rows, loaded.u_index, loaded.n_given, loaded.n_scalars) == (
        fresh.check, fresh.xi_rows, fresh.u_index, fresh.n_given, fresh.n_scalars)


def _fresh_srs():
    s = toy_srs(4)
    return Srs(g1_powers=s.g1_powers, g2=s.g2, s_g2=s.s_g2)


def test_g2_lines_saved_then_loaded(cache):
    want = toy_srs(4).decider_coeffs_host
    first = _fresh_srs()
    first.decider_coeffs("cpu")
    assert len(_entries(cache)) == 1
    second = _fresh_srs()
    for a, b in zip(second.decider_coeffs("cpu"), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(second.decider_coeffs_host, want):
        assert np.array_equal(a, b)
    assert first.content_hash() == second.content_hash() == toy_srs(4).content_hash()


def test_srs_content_hash_equals_the_jax_package():
    from snark_verifier_tpu.sdk.srs import toy_srs as j_toy_srs

    assert toy_srs(4).content_hash() == j_toy_srs(4).content_hash()
    assert toy_srs(4).content_hash() != toy_srs(4, seed=1).content_hash()


def test_a_corrupt_entry_is_deleted_and_recorded_again(cache, capsys):
    protocol = Snark.load(str(FIXTURES / "snark_00.json")).protocol
    plan_mod.succinct_plan(protocol, Bdfg21, "shplonk", "poseidon", device="cpu")
    (entry,) = _entries(cache)
    entry.write_bytes(b"not a cache entry")
    plan_mod._PLANS.clear()
    again = plan_mod.succinct_plan(protocol, Bdfg21, "shplonk", "poseidon", device="cpu")
    assert not again.from_cache
    assert "reload failed" in capsys.readouterr().err
    assert aot.try_load(entry.stem) is not None  # rewritten, readable
    # an entry that reads but does not decode (a key missing) goes the same way
    arrays, meta = aot.try_load(entry.stem)
    del arrays["tape_rows"]
    aot.save(entry.stem, (arrays, meta))
    plan_mod._PLANS.clear()
    again = plan_mod.succinct_plan(protocol, Bdfg21, "shplonk", "poseidon", device="cpu")
    assert not again.from_cache and "decode failed" in capsys.readouterr().err
    plan_mod._PLANS.clear()
    assert plan_mod.succinct_plan(protocol, Bdfg21, "shplonk", "poseidon",
                                  device="cpu").from_cache


def test_prune_evicts_the_least_recently_used(cache, monkeypatch):
    for i, name in enumerate("abc"):
        aot.save(name, ({"x": np.zeros(1000, np.uint8)}, {}))
        t = 1_000_000 + i
        os.utime(cache / f"{name}.npz", (t, t))
    size = (cache / "a.npz").stat().st_size
    monkeypatch.setenv("SNARK_AOT_MAX_BYTES", str(2 * size + size // 2))
    aot._prune()
    assert [p.stem for p in _entries(cache)] == ["b", "c"]
    assert aot.try_load("b") is not None  # a load touches b: c is now the oldest
    monkeypatch.setenv("SNARK_AOT_MAX_BYTES", str(size + size // 2))
    aot._prune()
    assert [p.stem for p in _entries(cache)] == ["b"]


def test_switch(cache, monkeypatch):
    monkeypatch.setenv("SNARK_AOT", "0")
    assert not aot.enabled("cuda") and not aot.enabled("cpu")
    protocol = Snark.load(str(FIXTURES / "snark_00.json")).protocol
    plan = plan_mod.succinct_plan(protocol, Bdfg21, "shplonk", "poseidon", device="cpu")
    assert not plan.from_cache and _entries(cache) == []
    _fresh_srs().decider_coeffs("cpu")
    assert _entries(cache) == []
    monkeypatch.delenv("SNARK_AOT")
    assert aot.enabled("cuda") and aot.enabled(torch.device("cuda", 1))
    assert not aot.enabled("cpu") and not aot.enabled(None)
