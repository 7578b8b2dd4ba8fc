"""No module the benchmark runs is JAX or the JAX package: top-level names
(the part before the first dot) compared whole, so ``gpd_tpu_torch``
passes where ``gpd_tpu`` fails; and the plain reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys

import pytest

from h100_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "gpd_tpu"}
PROGRAM = "gpd_tpu_torch"


def top_level_imports(path):
    """The top-level names a Python file imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compare_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "gpd_tpu")
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "gpd_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from h100_bench.reference import gpd, serve, train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gpd_tpu_torch', 'jax', 'jaxlib', 'flax', 'gpd_tpu'}))")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_loads_no_jax_module():
    """Every entry at tiny sizes on the CPU, in one fresh process:
    afterwards the process holds the program and no forbidden module."""
    code = ("import sys, tempfile; sys.path.insert(0, '.')\n"
            "from h100_bench import harness\n"
            "for cell in ('gpd15.table_stream', 'gpd3.pcd_stream',\n"
            "             'gpd15.train_epochs'):\n"
            "    with tempfile.TemporaryDirectory() as tmp:\n"
            "        harness.cpu_pass(cell, 7, False, tmp)\n"
            "print(harness.forbidden_modules(), 'gpd_tpu_torch' in sys.modules)")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
