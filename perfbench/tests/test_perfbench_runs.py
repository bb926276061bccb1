"""Whole runs of every cell on the CPU at a tiny size, each in its own
process: a sound run comes out correct and loads no module of JAX or the
JAX package; the control, and each fault planted in the program, come out
not correct.  The runs go side by side, a few at a time (a CPU run of the
program takes a minute or more)."""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

CASES = [
    ("verify-poseidon-b1024", "sound"), ("verify-keccak-b1024", "sound"),
    ("tree-l1024", "sound"), ("msm-k21", "sound"),
    ("verify-poseidon-b1024", "control"), ("tree-l1024", "control"), ("msm-k21", "control"),
    ("verify-poseidon-b1024", "answer_altered"), ("verify-poseidon-b1024", "half_batch"),
    ("tree-l1024", "answer_altered"), ("tree-l1024", "half_batch"),
    ("tree-l1024", "state_unchanged"),
    ("msm-k21", "answer_altered"), ("msm-k21", "half_batch"),
]


def _run(case):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(HERE, "dryrun.py"), *case], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=1500)
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return case, p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr[-3000:]


@pytest.fixture(scope="module")
def results(request):
    """Every selected case's run, side by side."""
    chosen = [it.callspec.params["case"] for it in request.session.items
              if hasattr(it, "callspec") and "case" in it.callspec.params]
    workers = max(1, min(6, (os.cpu_count() or 2) - 1))
    with ThreadPoolExecutor(workers) as ex:
        return {case: r for case, *r in ex.map(_run, chosen)}


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_run(results, case):
    rc, out, err = results[case]
    assert rc == 0 and out is not None, err
    assert out["forbidden"] == []
    if case[1] == "sound":
        assert out["correct"], out["checks"]
        assert "setup_s" in out["metrics"]
    else:
        assert not out["correct"], out["checks"]
