"""What the benchmark runs imports nothing of JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's) and reads nothing under benchmarks/; the reference imports
neither torch nor anything of the program; the fixtures are the copies the
manifest names."""

import ast
import hashlib
import json

from harness.catalog import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "snark_verifier_tpu"}
OLD = "bench" + "marks"  # the JAX-era folder, spelt so that this file does not name it


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "_cache" not in p.parts)


def test_no_file_imports_jax_or_the_jax_package():
    bad = [(p.name, m) for p in _sources() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    assert "snark_verifier_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_neither_torch_nor_the_program():
    bad = [(p.name, m) for p in sorted((BENCH_DIR / "reference").glob("*.py"))
           for m in _imports(p) if m.split(".")[0] in {"torch", "snark_verifier_tpu_torch", "numpy"}]
    assert bad == []


def test_no_file_reads_benchmarks():
    """No string of code (docstrings aside) names the benchmarks/ folder."""
    for p in _sources():
        tree = ast.parse(p.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
                assert OLD + "/" not in node.value and node.value != OLD, p.name


def test_fixtures_match_their_manifest():
    man = json.loads((BENCH_DIR / "fixtures" / "MANIFEST.json").read_text())["sha256"]
    files = {p.name for p in (BENCH_DIR / "fixtures").iterdir() if p.name != "MANIFEST.json"}
    assert files == set(man) and len(files) == 4
    for name, digest in man.items():
        assert hashlib.sha256((BENCH_DIR / "fixtures" / name).read_bytes()).hexdigest() == digest
