"""The torch package stands alone: no module of it, and not
chip_smoke.py, imports jax or the JAX package; and its entry points
refuse to run without a card unless the CPU is asked for."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "metabuli_work_tpu_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


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
