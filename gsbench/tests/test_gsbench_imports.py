"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "litegs_tpu")


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax_module(tiny):
    code = f"""
import json, sys
from gsbench import control, run
run.run_cell("garden1m-refine", 3, 0.5, False, "cpu",
             config_update={tiny!r})
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN)
    assert "litegs_torch" in loaded


def test_no_benchmark_source_imports_jax():
    for path in sorted((ROOT / "gsbench").rglob("*.py")):
        assert not set(_roots(path)) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "gsbench" / "reference").glob("*.py"))
    assert files
    for path in files:
        assert set(_roots(path)) <= {"__future__", "math", "typing", "numpy",
                                     "torch"}, path
    code = ("import sys, gsbench.reference.render, gsbench.reference.train,"
            " gsbench.reference.statistics, gsbench.reference.densify;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "litegs_torch" not in out.stdout
