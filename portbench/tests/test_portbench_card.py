"""The command on the card, one short run of each cell (the `cuda`
marker; skips here without a card):

    python -m pytest portbench/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import catalog


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  catalog.benchmark()["workloads"]])
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "4242", "--seconds", "3", "--trace", "0"],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": catalog.ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
