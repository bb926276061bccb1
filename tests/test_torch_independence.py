"""The port stands alone: snark_verifier_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, and chip_smoke.py gives no result without
a CUDA card or without the package beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# A meta-path hook that makes `jax` and `snark_verifier_tpu` unimportable.
_BLOCK = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "snark_verifier_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
"""


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    code = _BLOCK + """
import snark_verifier_tpu_torch
import snark_verifier_tpu_torch._build
import snark_verifier_tpu_torch.ec
import snark_verifier_tpu_torch.ec.glv
import snark_verifier_tpu_torch.ff
import snark_verifier_tpu_torch.msm
import snark_verifier_tpu_torch.msm.cuda_ops
import snark_verifier_tpu_torch.errors
import snark_verifier_tpu_torch.hash
import snark_verifier_tpu_torch.transcript
import snark_verifier_tpu_torch.loader.base
import snark_verifier_tpu_torch.loader.msm_expr
import snark_verifier_tpu_torch.pairing.py_pairing
import snark_verifier_tpu_torch.pcs.kzg.multiopen
import snark_verifier_tpu_torch.verifier.plonk.protocol
import snark_verifier_tpu_torch.verifier.plonk.verifier
import snark_verifier_tpu_torch.sdk.aggregation
import snark_verifier_tpu_torch.sdk.proof_io
import snark_verifier_tpu_torch.sdk.snark
import snark_verifier_tpu_torch.sdk.srs
import snark_verifier_tpu_torch.tower
import snark_verifier_tpu_torch.pairing.pairing
import snark_verifier_tpu_torch.pairing.fq12_vm
import snark_verifier_tpu_torch.pcs.kzg.decider
import snark_verifier_tpu_torch.parallel.batch_verify
import snark_verifier_tpu_torch.ff.fr_tape
import snark_verifier_tpu_torch.loader.tape_loader
import snark_verifier_tpu_torch.verifier.plonk.plan
import snark_verifier_tpu_torch.pcs.kzg.accumulator
import snark_verifier_tpu_torch.pcs.kzg.accumulation
import snark_verifier_tpu_torch.sdk.tree_aggregation
import snark_verifier_tpu_torch.pcs.ipa
import snark_verifier_tpu_torch.pcs.ipa.ipa
import snark_verifier_tpu_torch.pcs.ipa.bgh19
import snark_verifier_tpu_torch.pcs.ipa.plan
import snark_verifier_tpu_torch.pcs.ipa.fixtures
import snark_verifier_tpu_torch.parallel.mesh
import snark_verifier_tpu_torch.parallel.msm_sharded
import snark_verifier_tpu_torch.parallel.comm_model
import snark_verifier_tpu_torch.sdk.aot
import snark_verifier_tpu_torch.utils.py_poly
import snark_verifier_tpu_torch.pcs.kzg.prover_py
import snark_verifier_tpu_torch.system.standard_plonk
import snark_verifier_tpu_torch.system.linearized_plonk
import snark_verifier_tpu_torch.system.vanilla_plonk
import snark_verifier_tpu_torch.system.vanilla_fixtures
import snark_verifier_tpu_torch.system.vk_digest
from snark_verifier_tpu_torch.sdk.srs import save_params, toy_srs
from snark_verifier_tpu_torch.sdk.snark import gen_dummy_snark
from snark_verifier_tpu_torch.transcript import PoseidonTranscriptWriter
from snark_verifier_tpu_torch.verifier.plonk.protocol import Domain
from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkVerifier, verify_snark_native
from snark_verifier_tpu_torch.pcs.ipa import IpaProvingKey
assert Domain.bn254(3).n == 8 and hasattr(toy_srs(2), "commit")
from snark_verifier_tpu_torch.parallel import (
    Mesh, batch_msm_sharded, batch_verify, batch_verify_sharded, msm_sharded,
)
from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_sharded, tree_comm_inventory
assert Mesh(["cpu"] * 2, ("batch",)).shape == {"batch": 2}
from snark_verifier_tpu_torch.pcs.ipa import (
    Bgh19, Ipa, IpaAccumulator, IpaAs, IpaDecidingKey, IpaSuccinctVerifyingKey, decide,
    decide_all,
)
assert all(hasattr(c, "from_jax") for c in (IpaAccumulator, IpaDecidingKey,
                                            IpaSuccinctVerifyingKey))
snark_verifier_tpu_torch.pcs.ipa.fixtures.ipa_keys()
import snark_verifier_tpu_torch.verifier.cost
import snark_verifier_tpu_torch.loader.yul_interp
import snark_verifier_tpu_torch.loader.evm_loader
import snark_verifier_tpu_torch.loader.evm_debug
import snark_verifier_tpu_torch.sdk.evm
import snark_verifier_tpu_torch.utils.timing
import snark_verifier_tpu_torch.sdk.bincode_io
import snark_verifier_tpu_torch.hash.poseidon_optimized
import snark_verifier_tpu_torch.utils.hypercube
import snark_verifier_tpu_torch.utils.native
import snark_verifier_tpu_torch.__main__
import snark_verifier_tpu_torch.examples.verify_standard_plonk
import snark_verifier_tpu_torch.examples.verify_vanilla_plonk
import snark_verifier_tpu_torch.examples.aggregate_proofs
import snark_verifier_tpu_torch.examples.aggregate_mixed
import snark_verifier_tpu_torch.examples.gen_evm_verifier
from snark_verifier_tpu_torch.sdk.aggregation import batch_verify as sdk_batch_verify
from snark_verifier_tpu_torch.utils.timing import METER
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "snark_verifier_tpu")]
assert not bad, bad
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_port_sources_name_no_jax():
    pkg = REPO / "snark_verifier_tpu_torch"
    port = sorted(f for f in pkg.rglob("*.py") if "build" not in f.relative_to(pkg).parts)
    for f in port + [REPO / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "snark_verifier_tpu." not in s.replace(
                    "snark_verifier_tpu_torch", ""), f"{f}: {s}"
                assert not s.startswith(("import snark_verifier_tpu ", "from snark_verifier_tpu ")), s


def test_chip_smoke_gives_no_result_without_a_card():
    proc = _run(_BLOCK + "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cli_help_without_jax():
    """`python -m snark_verifier_tpu_torch --help` under the block: every
    command listed, nothing of jax or the JAX package imported."""
    code = _BLOCK + """
import runpy
sys.argv = ["snark_verifier_tpu_torch", "--help"]
try:
    runpy.run_module("snark_verifier_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "snark_verifier_tpu")]
assert not bad, bad
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    for cmd in ("verify", "aggregate", "aggregate-mixed", "tree", "bench-msm",
                "gen-evm-verifier"):
        assert cmd in proc.stdout
