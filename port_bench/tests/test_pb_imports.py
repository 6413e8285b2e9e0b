"""Import guard: nothing under ``port_bench/`` imports JAX or the JAX
package, and the reference imports nothing of the program.  Modules are
compared by their top-level name (before the first dot), whole: the
port's name begins with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys

from .conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "deepclr_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "port_bench"
            elif node.module:
                yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "deepclr_tpu_torch" not in set(_imports(path)), path
    for path in (BENCH / "yardstick").rglob("*.py"):
        assert "deepclr_tpu_torch" not in set(_imports(path)), path


def test_no_jax_loaded_by_a_run():
    """What the harness and the port load in one process: a CPU cell's
    modules, read after it, hold no forbidden top-level name."""
    code = (
        "import sys, torch; sys.path.insert(0, '.');"
        "from port_bench.harness import forbidden_modules, run_cell;"
        "import port_bench.entries, port_bench.check, port_bench.trace;"
        "import deepclr_tpu_torch.engine, deepclr_tpu_torch.models, deepclr_tpu_torch.solver;"
        "print(','.join(forbidden_modules()) or 'none')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the harness, or without
    a card, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "kitti.train", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
