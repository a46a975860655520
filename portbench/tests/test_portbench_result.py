"""The result line's shape, and what a run does without a card."""

import json
import os
import subprocess
import sys

from portbench import catalog
from portbench import run as bench_run

from .conftest import tiny_config, tiny_traffic


def test_result_line(tiny_root):
    bench = catalog.benchmark()
    for trace_on in (False, True):
        res = bench_run.run_cell(bench, "gtdb40.api-se150", 3, 1.0, trace_on,
                                 device="cpu", root=tiny_root,
                                 cfg=tiny_config(((2, 2),)),
                                 traffic=tiny_traffic("api-se150"))
        line = json.loads(json.dumps(res))
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for name, m in line["metrics"].items():
            assert set(m) == {"value", "unit"}
            assert isinstance(m["value"], float)
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        names = set(line["metrics"])
        if trace_on:
            assert names <= {"dispatch_ms", "call_p50_ms", "score_ms",
                             "path_dp_roofline", "peak_device_gib"}
            assert {"dispatch_ms", "call_p50_ms", "score_ms"} <= names
        else:
            assert names == {"reads_per_s", "call_p95_ms", "setup_s"}


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line (this sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "gtdb40.paired150", "--seed", "1", "--seconds", "1"],
        cwd=catalog.ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": catalog.ROOT})
    assert out.returncode == 2
    assert "{" not in out.stdout
