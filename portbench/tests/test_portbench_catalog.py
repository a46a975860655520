"""BENCHMARK.json against the files the harness finds by name, the
limits its format keeps to, and a new configuration, mix and metric
picked up without an edit to any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return catalog.benchmark()


def test_every_name_resolves(bench):
    for c in bench["configs"]:
        cfg = catalog.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"]
        catalog.database_kind(cfg["kind"])
    for w in bench["workloads"]:
        t = catalog.traffic(w["traffic"])
        catalog.generator(t["kind"])
        catalog.entry(t["entry"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"]:
        assert hasattr(catalog.endtoend_reader(m["name"]), "read")
    for m in bench["per_layer"]:
        assert hasattr(catalog.metric_reader(m["name"]), "read")


def test_format_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        reported = catalog.cell_metrics(bench, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert catalog.cell_metrics(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(bench)) < 64 * 1024


def test_cell_metrics_follow_workloads(bench):
    e2e = [m["name"] for m in catalog.cell_metrics(bench, "gtdb40.api-se150",
                                                   False)]
    assert e2e == ["reads_per_s", "call_p95_ms", "setup_s"]
    layer = [m["name"] for m in catalog.cell_metrics(bench, "gtdb40.long",
                                                     True)]
    assert "call_p50_ms" not in layer and "input_ms" in layer


NEW_FILES = {
    "configs/tiny9.json": {"name": "tiny9", "kind": "clades", "db_seed": 9,
                           "families": [[2]], "genome_len": 30000,
                           "gene_len": 300, "third_position_weight": 8,
                           "species_divergence": 0.1,
                           "genus_divergence": 0.1, "syncmer": True,
                           "smer_len": 5, "mask_mode": 0},
    "traffic/se99.json": {"kind": "reads", "entry": "classify_file"},
}
NEW_METRIC = '"""A metric a later change adds."""\n\n\ndef read(run):\n    return 7.0\n'


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the harness with a new configuration, mix and metric
    added as files and BENCHMARK.json entries finds all three."""
    root = tmp_path / "checkout"
    shutil.copytree(catalog.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = catalog.benchmark()
    for rel, body in NEW_FILES.items():
        (root / "portbench" / rel).write_text(json.dumps(body))
    (root / "portbench" / "metrics" / "extra_ms.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny9", "source": "x",
                             "file": "portbench/configs/tiny9.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny9.se99", "config": "tiny9",
                               "traffic": "se99", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "extra_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "io", "moves": "reads_per_s",
                               "workloads": ["tiny9.se99"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import catalog as c\n"
            "b = c.benchmark()\n"
            "w = c.cell(b, 'tiny9.se99')\n"
            "print(c.config(w['config'])['genome_len'],"
            " c.traffic(w['traffic'])['entry'],"
            " [m['name'] for m in c.cell_metrics(b, w['name'], True)][-1],"
            " c.metric_reader('extra_ms').read(None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["30000", "classify_file", "extra_ms", "7.0"]
