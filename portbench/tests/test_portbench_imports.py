"""Nothing the benchmark runs imports JAX or the JAX package (compared
by whole top-level module names: metabuli_work_tpu_torch is the
program, metabuli_work_tpu is not allowed), and the reference imports
nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "metabuli_work_tpu"}


def _modules():
    for d, _, files in os.walk(catalog.PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, catalog.PKG))
def test_no_jax_imports(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(catalog.PKG, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            got = set(_imports(os.path.join(ref, f)))
            assert got <= {"numpy", "statistics"}, (f, got)


def test_run_loads_no_jax(tiny_root):
    """A whole CPU run in a fresh process leaves no JAX module loaded."""
    code = ("import sys\n"
            "from portbench import catalog, run\n"
            "from portbench.tests.conftest import tiny_config, tiny_traffic\n"
            f"r = run.run_cell(catalog.benchmark(), 'gtdb40.paired150', 1, 0.5,"
            f" False, device='cpu', root={tiny_root!r},"
            " cfg=tiny_config(), traffic=tiny_traffic('paired150'))\n"
            "print(r['correct'], run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": catalog.ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True []"
