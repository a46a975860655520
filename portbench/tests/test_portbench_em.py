"""The EM cell gtdb40.em-paired150: its four readers on a synthetic run
(in the style of test_portbench_stream.py), its entry, configuration
and traffic mix, and a CPU run of the cell on a tiny cut of its
configuration."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import catalog
from portbench import run as bench_run
from portbench.generators import reads as gen

from .conftest import tiny_config, tiny_traffic

CELL = "gtdb40.em-paired150"
READERS = ("em_ms", "em_map_ms", "em_reclassify_ms", "em_mappings")
# the metrics of the resident cells that read the EM cell too
SHARED = {"input_ms", "prep_ms", "extract_ms", "extract_device_ms",
          "probe_ms", "probe_device_ms", "paths_ms", "paths_device_ms",
          "redundancy_ms", "redundancy_ops", "redundancy_device_ms",
          "gc_ms", "dispatch_ops", "db_load_s", "layout_s", "upload_s"}


def _run(em=None, spans=None, with_slice=True):
    """A run of the harness: a window of 0-100 s holding three passes of
    four batches each, each pass followed by its EM pass (0.5 s, of it
    0.1 s em_map, 0.3 s em_iter, 0.1 s em_reclassify); the traced slice
    37.5-39.5 s holds the second pass's last batch."""
    if spans is None:
        spans = []
        for at in (20.0, 40.0, 70.0):
            spans += [("em_map", at, at + 0.1), ("em_iter", at + 0.1,
                                                  at + 0.4),
                      ("em_reclassify", at + 0.4, at + 0.5),
                      ("em", at, at + 0.5), ("score", at - 1, at - 0.5)]
    ends = [at - k for at in (20.0, 39.0, 70.0) for k in (4, 3, 2, 1)]
    run = bench_run.Run.__new__(bench_run.Run)
    run.slice = SimpleNamespace(excluded=lambda t: 37.5 <= t <= 39.5) \
        if with_slice else None
    passes = [{"iterations": 5, "species": 3, "mapped": 1000,
               "mappings": m} for m in (1500, 1600, 1700)] \
        if em is None else em
    run.win = {"t0": 0.0, "t1": 100.0, "batch_ends": ends,
               "queries": 3 * 1024, "em": passes}
    run.clf = SimpleNamespace(timer=SimpleNamespace(spans=spans))
    return run


def _read(name, run):
    return catalog.metric_reader(name).read(run)


def test_span_readers():
    """Three EM passes over twelve batches, the slice's two batches
    counted: no EM span lies in the slice."""
    run = _run()
    assert _read("em_ms", run) == pytest.approx(500 * 3 / 12)
    assert _read("em_map_ms", run) == pytest.approx(100 * 3 / 12)
    assert _read("em_reclassify_ms", run) == pytest.approx(100 * 3 / 12)
    # untraced: the same
    assert _read("em_ms", _run(with_slice=False)) == \
        pytest.approx(500 * 3 / 12)


def test_mappings_reader():
    run = _run()
    assert _read("em_mappings", run) == pytest.approx(4800 / 3072)
    # a pass with no mapping (run_em returns None) counts 0
    none = _run(em=[None, {"iterations": 1, "species": 1, "mapped": 5,
                           "mappings": 6}])
    assert _read("em_mappings", none) == pytest.approx(6 / 3072)


def test_nothing_to_read_is_none():
    """An older program (no em spans; run_em's return without
    `mappings`) and an entry with no EM pass read nothing and raise
    nothing."""
    old = _run(em=[{"iterations": 5, "species": 3, "mapped": 1000}] * 3,
               spans=[("score", 10.0, 10.5)])
    for name in READERS:
        assert _read(name, old) is None, name
    plain = _run(spans=[])
    del plain.win["em"]
    for name in READERS:
        assert _read(name, plain) is None, name


def test_benchmark_entries():
    bench = catalog.benchmark()
    cell = catalog.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("gtdb40-em", "em-paired150", 1)
    assert catalog.config(cell["config"])["name"] == "gtdb40-em"
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["layer"] == "classify.em"
        assert per[name]["moves"] == "reads_per_s"
    listed = {m["name"] for m in catalog.cell_metrics(bench, CELL, True)}
    # with the metrics every cell reports (score_ms, dispatch_ms, the
    # path DP's roofline, peak memory)
    assert set(READERS) | SHARED | {"score_ms", "dispatch_ms",
                                    "path_dp_roofline",
                                    "peak_device_gib"} == listed
    for name in SHARED:
        assert per[name]["workloads"][-1] == CELL


def test_traffic_is_paired150_with_em():
    """The mix is paired150 with `em` in `params`, the EM entry and half
    the sample; `em` reaches ClassifyParams and equals the
    configuration's."""
    from metabuli_work_tpu_torch.classify.pipeline import ClassifyParams

    t, p = catalog.traffic("em-paired150"), catalog.traffic("paired150")
    assert t.pop("params") == {"em": True}
    assert t.pop("sample_queries") == 65536
    assert (t.pop("entry"), p.pop("entry")) == ("classify_file_em",
                                                "classify_file")
    p.pop("sample_queries")
    assert t == p
    t = catalog.traffic("em-paired150")
    params = ClassifyParams(seq_mode=t["seq_mode"], min_score=t["min_score"],
                            min_sp_score=t["min_sp_score"],
                            batch_size=t["batch"], **t.get("params", {}))
    assert params.em is True and params.seq_mode == 2
    assert catalog.config("gtdb40-em")["em"] == t["params"]["em"]
    genomes = catalog.database_kind("clades").genomes(tiny_config(((2, 2),)))
    s = gen.draw(genomes, t, 32, np.random.default_rng(5))
    assert len(s) == 32 and s.seqs2 is not None


def test_configuration_is_gtdb40_with_em():
    """Every key that makes the genomes and the DB is gtdb40's; the new
    file adds `em` and its deployment, and is cut as gtdb40 is."""
    a, b = catalog.config("gtdb40"), catalog.config("gtdb40-em")
    made = {k for k in a if k not in bench_run.DESCRIPTIVE}
    assert {k: b[k] for k in made} == {k: a[k] for k in made}
    assert set(b) - set(a) == {"em", "deployment"}
    assert set(b["reduced_because"]) == set(a["reduced_because"])
    entry = next(c for c in catalog.benchmark()["configs"]
                 if c["name"] == "gtdb40-em")
    assert entry["reduced"] == ["families", "genome_len"]
    assert entry["source"] == b["source"] and len(b["source"]) <= 200
    ta, tb = tiny_config(((2, 2),)), tiny_config(((2, 2),),
                                                  base="gtdb40-em")
    kind = catalog.database_kind("clades")
    assert np.array_equal(kind.genomes(ta), kind.genomes(tb))


def test_cell_on_the_cpu_is_correct(tiny_root, monkeypatch):
    """The cell through the harness on a tiny configuration: correct
    against the plain reference, a run_em return a pass, every new
    metric read, and the traced slice (from the window's start here)
    started at a pass's first batch and stopped before its EM pass."""
    monkeypatch.setattr(bench_run, "SLICE_FROM", 0.0)
    cfg = tiny_config(((2, 2),), base="gtdb40-em")
    seen = []
    measure = bench_run.measure

    def keep(run, state):
        measure(run, state)
        sl = run.slice
        assert sl.t_start >= run.win["batch_ends"][0]
        assert not [a for n, a, _ in run.clf.timer.spans
                    if n == "em" and sl.t_start <= a <= sl.t_end]
        seen.append((run.clf.params.em, list(run.win["em"]),
                     len(run.win["batch_ends"])))

    monkeypatch.setattr(bench_run, "measure", keep)
    res = bench_run.run_cell(catalog.benchmark(), CELL, 2 ** 31 + 91, 3.0,
                             True, device="cpu", root=tiny_root, cfg=cfg,
                             traffic=tiny_traffic("em-paired150"))
    line = json.loads(json.dumps(res))
    assert line["correct"], line["checks"]
    assert line["checks"]["mismatched_reads"]["value"] == 0
    em, passes, batches = seen[0]
    assert em and passes and batches == 3 * len(passes)
    assert all(p["mappings"] >= p["mapped"] > 0 for p in passes)
    m = line["metrics"]
    for name in READERS:
        assert m[name]["value"] > 0, name
    assert m["em_ms"]["value"] > m["em_map_ms"]["value"]
    assert m["em_mappings"]["unit"] == "mappings"
    assert {"score_ms", "input_ms", "dispatch_ms"} <= set(m)
