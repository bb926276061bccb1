"""The port's user surface: the CLI (`python -m snark_verifier_tpu_torch`),
the examples and `sdk.aggregation.batch_verify`, against the JAX package's
CLI and the port's python-int verifier.  On the CPU (`--cpu`, device
"cpu"); without the flag every device command refuses to run here."""

import pytest
import torch

import snark_verifier_tpu.__main__ as jcli

import snark_verifier_tpu_torch.__main__ as cli
from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.ff.spec import FR
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system.standard_plonk import StandardPlonk, build_protocol, prove
from snark_verifier_tpu_torch.verifier.plonk.verifier import verify_snark_native

from test_torch_independence import _BLOCK, _run

torch.set_num_threads(1)

COMMANDS = ["verify", "aggregate", "aggregate-mixed", "tree", "bench-msm", "gen-evm-verifier"]


def _jax_args(monkeypatch, argv):
    """The JAX CLI's parsed arguments for argv, its command not run."""
    seen = {}
    for name in ("cmd_verify", "cmd_aggregate", "cmd_aggregate_mixed", "cmd_tree",
                 "cmd_bench_msm", "cmd_gen_evm_verifier"):
        monkeypatch.setattr(jcli, name, lambda args: seen.update(vars(args)))
    jcli.main(argv)
    return seen


@pytest.mark.parametrize("argv", [[c] for c in COMMANDS] + [
    ["verify", "--scheme", "gwc", "--k", "5", "--cpu"],
    ["aggregate", "--n", "8"],
    ["tree", "--n", "32", "--fanout", "8", "--cpu"],
    ["bench-msm", "--log2n", "20"],
    ["gen-evm-verifier", "--scheme", "gwc", "--k", "4", "--out", "x.yul", "--no-check"],
])
def test_commands_and_defaults_equal_the_jax_cli(monkeypatch, argv):
    want = _jax_args(monkeypatch, argv)
    want.pop("backend", None)  # the port's msm stands for msm_rns: no --backend
    assert vars(cli.parser().parse_args(argv)) == want
    assert set(cli.COMMANDS) == set(COMMANDS)


@pytest.mark.parametrize("argv", [["verify"], ["aggregate"], ["aggregate-mixed"], ["tree"],
                                  ["bench-msm"]])
def test_device_commands_refuse_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_gen_evm_verifier_end_to_end_on_the_host(monkeypatch, tmp_path, capsys):
    """gen-evm-verifier --k 3 writes the JAX CLI's contract, accepts its own
    proof and rejects a tampered one, and never builds the CUDA library."""
    def no_build():
        raise AssertionError("gen-evm-verifier built the CUDA library")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = sorted(_build.BUILD_DIR.glob("libsvt_*")) if _build.BUILD_DIR.exists() else []
    out = tmp_path / "port.yul"
    cli.main(["gen-evm-verifier", "--k", "3", "--out", str(out)])
    text = capsys.readouterr()
    assert "PASS" in text.out and "gas_used=" in text.out and "revert" in text.out
    assert "# cost-meter" in text.err
    jout = tmp_path / "jax.yul"
    jcli.main(["gen-evm-verifier", "--k", "3", "--out", str(jout), "--no-check"])
    assert out.read_text() == jout.read_text()
    after = sorted(_build.BUILD_DIR.glob("libsvt_*")) if _build.BUILD_DIR.exists() else []
    assert after == before


def test_bench_msm_on_the_cpu(capsys):
    cli.main(["bench-msm", "--cpu", "--log2n", "8"])
    out = capsys.readouterr().out
    assert "correct=True overflow=False" in out and "points/s" in out and "PASS" in out


def test_sdk_batch_verify_is_the_parallel_body(monkeypatch):
    """sdk.aggregation.batch_verify on [good, tampered] StandardPlonk k = 3
    proofs equals verify_snark_native lane by lane, through
    parallel.batch_verify's body."""
    import sys

    import snark_verifier_tpu_torch.parallel  # noqa: F401  (the package's attribute is the function)
    from snark_verifier_tpu_torch.sdk.aggregation import batch_verify

    pbv = sys.modules["snark_verifier_tpu_torch.parallel.batch_verify"]
    calls = []
    body = pbv.batch_verify_sharded
    monkeypatch.setattr(pbv, "batch_verify_sharded",
                        lambda *a, **k: calls.append(len(a[0])) or body(*a, **k))
    srs = toy_srs(32)
    circuit = StandardPlonk.rand(k=3, seed=1)
    protocol = build_protocol(circuit, srs, device="cpu")
    sc, pts = prove(circuit, protocol, srs, scheme="shplonk", device="cpu")
    good = Snark(protocol, [list(circuit.instance)], sc, pts)
    bad = Snark(protocol, [[(circuit.instance[0] + 1) % FR.p]], sc, pts)
    got = [bool(v) for v in batch_verify([good, bad], srs, "shplonk", device="cpu")]
    assert got == [verify_snark_native(s, srs, "shplonk") for s in (good, bad)] == [True, False]
    assert calls == [2]


def test_examples_import_without_jax():
    code = _BLOCK + """
from snark_verifier_tpu_torch.examples import (
    aggregate_mixed, aggregate_proofs, gen_evm_verifier, verify_standard_plonk,
    verify_vanilla_plonk,
)
for m in (aggregate_mixed, aggregate_proofs, gen_evm_verifier, verify_standard_plonk,
          verify_vanilla_plonk):
    assert callable(m.main)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "snark_verifier_tpu")]
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"
