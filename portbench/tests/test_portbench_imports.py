"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "healnet_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax(path):
    assert not set(_imports(BENCH / path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "healnet_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    """A tiny run on the CPU in a fresh process, then its modules."""
    code = ("import sys; from portbench.tests.tiny import run_tiny; r = run_tiny(); "
            "from portbench.run import forbidden_modules; "
            "print('FOUND', forbidden_modules(), 'PORT', 'healnet_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] PORT True" in out.stdout


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "brca.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
