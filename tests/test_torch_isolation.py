"""The torch package stands alone: no module of it (parallel/ included),
and neither chip_smoke.py, the shared test inputs it imports
(torch_dp_cases.py) nor the distributed test's worker, imports jax or
the JAX package; and its entry points refuse to run without a card
unless the CPU is asked for."""

import ast
import os

import pytest
import torch

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "metabuli_work_tpu_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "torch_distributed_worker.py"),
           os.path.join(REPO, "tests", "torch_dp_cases.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_sources_cover_the_parallel_package():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for f in ("sharding.py", "distributed.py", "scaling.py"):
        assert os.path.join("metabuli_work_tpu_torch", "parallel", f) in rel


def test_sources_cover_the_host_tools():
    """The build options, upkeep, filter, taxonomy and report modules,
    read grouping and the UniRef tools."""
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for f in ("index/minhash.py", "index/orf.py", "index/prodigal.py",
              "index/builder.py", "index/update.py", "index/packing.py",
              "classify/filter.py", "taxonomy/gtdb.py", "taxonomy/tools.py",
              "report/grade.py", "report/extract.py", "report/refiner.py",
              "report/benchmark.py", "report/virus_benchmark.py", "cli.py",
              "index/common.py", "ops/encode_aa.py", "readgroup/grouping.py",
              "readgroup/apply.py", "uniref/tree.py", "uniref/db.py",
              "uniref/classifier.py"):
        assert f in rel, f


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "metabuli_work_tpu"), \
            f"{path} imports {mod}"


def test_every_port_test_module_takes_the_thread_fixture():
    """Each tests/test_torch_*.py imports torch_port_db.one_torch_thread
    at its top level, which makes the fixture autouse in that module: a
    file that forgot it would run its torch operators on a thread pool
    a core wide in every tier-1 worker."""
    tests = os.path.join(REPO, "tests")
    files = sorted(f for f in os.listdir(tests)
                   if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(files) > 20
    for f in files:
        path = os.path.join(tests, f)
        tree = ast.parse(open(path).read(), path)
        assert any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_port_db"
                   and any(a.name == "one_torch_thread" and a.asname is None
                           for a in node.names)
                   for node in tree.body), \
            f"{f} does not import torch_port_db.one_torch_thread"


def test_entry_points_need_a_card_unless_cpu_requested(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from metabuli_work_tpu_torch.index.builder import build_database

    from torch_port_db import build_db

    db = build_db(build_database, str(tmp_path), "db", syncmer=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Classifier(db, ClassifyParams(seq_mode=1))
    from metabuli_work_tpu_torch.classify.filter import filter_reads

    reads = tmp_path / "reads.fna"
    reads.write_text(">r0\n" + "ACGT" * 40 + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        filter_reads(str(reads), [db], str(tmp_path / "out"), "job",
                     ClassifyParams(seq_mode=1))
    assert not (tmp_path / "out").exists()
