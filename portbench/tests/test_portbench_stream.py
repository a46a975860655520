"""The streamed-index cell gtdb40.stream-paired150: its six readers of
the range uploads on a synthetic run (in the style of
test_portbench_spans.py), its entries, configuration and traffic mix,
and a CPU run of the cell on a tiny cut of its configuration under a
budget that streams."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import catalog, trace
from portbench import run as bench_run
from portbench.generators import reads as gen

from .conftest import tiny_config, tiny_traffic

CELL = "gtdb40.stream-paired150"
READERS = ("range_upload_ms", "range_stage_ms", "range_wait_ms",
           "range_upload_device_ms", "range_gb", "range_upload_roofline")
# the metrics of the resident cells that read the streamed cell too
SHARED = {"input_ms", "prep_ms", "extract_ms", "probe_ms", "paths_ms",
          "gc_ms", "dispatch_ops", "extract_device_ms", "probe_device_ms",
          "paths_device_ms", "db_load_s", "layout_s"}
RANGE_BYTES = 1_500_000_000


def _ev(name, start, end, device=False, id=0, link=0, stream=7,
        thread=1):
    return trace.Record(name, device, start, end, id, link, stream, thread)


def _events():
    # a 2-s slice (us).  On the host: a probe holding two range uploads,
    # each with its wait, its staging and two copies launched after them,
    # and a gather; a prep before it with the copy of the reads.
    ev = [_ev(trace.MARK_START, 0, 0), _ev(trace.MARK_END, 2e6, 2e6),
          _ev("stage:prep", 50_000, 90_000, id=20),
          _ev("aten::copy_", 60_000, 61_000, id=21),
          _ev("stage:probe", 100_000, 1_500_000, id=1),
          _ev("aten::index", 600_000, 601_000, id=14)]
    for k, at in enumerate((500_000, 1_000_000)):
        i = 100 * (k + 1)
        ev += [_ev("stage:upload", at, at + 20_000, id=i),
               _ev("stage:range_wait", at, at + 5_000, id=i + 1),
               _ev("stage:range_stage", at + 5_000, at + 15_000, id=i + 2),
               _ev("aten::copy_", at + 16_000, at + 17_000, id=i + 3),
               _ev("aten::copy_", at + 17_000, at + 18_000, id=i + 4),
               _ev("Memcpy HtoD (Pinned -> Device)", at + 16_500,
                   at + 36_500, True, link=i + 3),
               _ev("Memcpy HtoD (Pinned -> Device)", at + 36_500,
                   at + 56_500, True, link=i + 4)]
    ev += [_ev("Memcpy HtoD (Pageable -> Device)", 61_000, 62_000, True,
               link=21),
           _ev("k_gather", 601_000, 606_000, True, link=14)]
    return ev


def _run(events=None, stats=None, with_slice=True):
    """A run of the harness: host spans on perf_counter seconds (window
    0-100 s, the traced slice 40-42 s), batch ends and a program whose
    streamed index has ranges of RANGE_BYTES."""
    run = bench_run.Run.__new__(bench_run.Run)
    spans_ = [("upload", -5.0, -4.0)]                    # the set-up's
    for at in (10.0, 10.1, 40.5, 41.0):
        spans_ += [("upload", at, at + 0.02), ("range_wait", at, at + 0.005),
                   ("range_stage", at + 0.005, at + 0.015)]
    run.slice = None
    if with_slice:
        run.slice = SimpleNamespace(
            events=_events() if events is None else events,
            t_start=40.0, t_end=42.0,
            excluded=lambda t: 40.0 <= t <= 42.0)
    run.win = {"t0": 0.0, "t1": 100.0, "batch_ends": [11.0, 12.0, 41.5,
                                                      60.0]}
    if stats is None:
        stats = {"sweeps": 3, "bytes": 3 * RANGE_BYTES, "copy_s": 0.1,
                 "range_bytes": RANGE_BYTES, "n_ranges": 4}
    run.clf = SimpleNamespace(timer=SimpleNamespace(spans=spans_),
                              range_stats=lambda: dict(stats))
    return run


def _read(name, run):
    return catalog.metric_reader(name).read(run)


def test_host_readers():
    """Outside the slice: two range uploads over three batches."""
    run = _run()
    assert _read("range_upload_ms", run) == pytest.approx(40 / 3)
    assert _read("range_wait_ms", run) == pytest.approx(10 / 3)
    assert _read("range_stage_ms", run) == pytest.approx(20 / 3)
    assert _read("range_gb", run) == pytest.approx(
        2 * RANGE_BYTES / 3 / 1e9)


def test_device_readers():
    """In the slice: two uploads, four copies of 20 ms, one batch; the
    copy of the reads (prep) and the gather (probe) are not the
    uploads'."""
    run = _run()
    assert _read("range_upload_device_ms", run) == pytest.approx(80.0)
    least_s = 2 * RANGE_BYTES / 64e9
    assert _read("range_upload_roofline", run) == pytest.approx(
        100 * least_s / 0.080)
    # half the device time for the same bytes: twice the share
    ev = [e._replace(end=e.start + (e.end - e.start) / 2)
          if e.name.startswith("Memcpy HtoD (Pinned") else e
          for e in _events()]
    assert _read("range_upload_roofline", _run(events=ev)) == \
        pytest.approx(2 * 100 * least_s / 0.080)


def test_nothing_to_read_is_none():
    """An older program (range stats without range_bytes, no range_stage or
    range_wait spans), a resident classifier, no slice or no copies in
    it: the readers return None and raise nothing."""
    old = _run(stats={"sweeps": 3, "bytes": 1, "copy_s": 0.1})
    assert _read("range_gb", old) is None
    assert _read("range_upload_roofline", old) is None
    old.clf.timer.spans = [s for s in old.clf.timer.spans
                           if s[0] == "upload"]
    assert _read("range_stage_ms", old) is None
    assert _read("range_wait_ms", old) is None
    resident = _run(events=[e for e in _events() if e.name not in (
        "stage:upload", "stage:range_wait", "stage:range_stage")])
    resident.clf = SimpleNamespace(timer=SimpleNamespace(spans=[]))
    for name in READERS:
        assert _read(name, resident) is None, name
    no_slice = _run(with_slice=False)
    assert _read("range_upload_roofline", no_slice) is None
    assert _read("range_upload_device_ms", no_slice) is None
    no_copies = _run(events=[e for e in _events()
                             if not e.name.startswith("Memcpy")])
    assert _read("range_upload_roofline", no_copies) is None
    assert _read("range_upload_device_ms", no_copies) is None


def test_benchmark_entries():
    bench = catalog.benchmark()
    cell = catalog.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("gtdb40-stream", "stream-paired150", 1)
    assert catalog.config(cell["config"])["name"] == "gtdb40-stream"
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["layer"] == "classify.stream"
        assert per[name]["moves"] == "reads_per_s"
    listed = {m["name"] for m in catalog.cell_metrics(bench, CELL, True)}
    assert set(READERS) | SHARED <= listed
    # the metrics of the paired flow's other layers, and not the set-up
    # upload's or the API call's
    assert not listed & {"upload_s", "pad_ms", "call_p50_ms"}


def test_traffic_is_paired150_streamed():
    """The mix is paired150 with the card budget in `params` and half the
    sample; the loader and the generator take it as they take
    paired150, and the budget reaches ClassifyParams."""
    from metabuli_work_tpu_torch.classify.pipeline import ClassifyParams

    t, p = catalog.traffic("stream-paired150"), catalog.traffic("paired150")
    assert t.pop("params") == {"hbm_budget_gb": 0.75}
    assert t.pop("sample_queries") == 65536
    p.pop("sample_queries")
    assert t == p
    t = catalog.traffic("stream-paired150")
    params = ClassifyParams(seq_mode=t["seq_mode"], min_score=t["min_score"],
                            min_sp_score=t["min_sp_score"],
                            batch_size=t["batch"], **t.get("params", {}))
    assert params.hbm_budget_gb == 0.75 and params.seq_mode == 2
    genomes = catalog.database_kind("clades").genomes(tiny_config(((2, 2),)))
    rng = np.random.default_rng(5)
    s = gen.draw(genomes, t, 32, rng)
    assert len(s) == 32 and s.seqs2 is not None


def test_configuration_is_gtdb40_held_on_the_host():
    """Every key that makes the genomes and the DB is gtdb40's; the new
    file adds the card budget, the one the mix hands the program, and
    says why it was cut."""
    a, b = catalog.config("gtdb40"), catalog.config("gtdb40-stream")
    made = {k for k in a if k not in bench_run.DESCRIPTIVE}
    assert {k: b[k] for k in made} == {k: a[k] for k in made}
    assert b["hbm_budget_gb"] == \
        catalog.traffic("stream-paired150")["params"]["hbm_budget_gb"]
    assert set(b["reduced_because"]) == \
        set(a["reduced_because"]) | {"hbm_budget_gb"}
    entry = next(c for c in catalog.benchmark()["configs"]
                 if c["name"] == "gtdb40-stream")
    assert set(entry["reduced"]) == set(b["reduced_because"])
    ta, tb = tiny_config(((2, 2),)), tiny_config(((2, 2),),
                                                  base="gtdb40-stream")
    kind = catalog.database_kind("clades")
    assert np.array_equal(kind.genomes(ta), kind.genomes(tb))


def test_cell_on_the_cpu_streams_and_is_correct(tiny_root, monkeypatch):
    """The cell through the harness on a tiny configuration, with the
    mix's budget set so the tiny DB streams in 4 ranges: correct against
    the plain reference, and the host-side readers report."""
    from metabuli_work_tpu_torch.index.format import load_index

    cfg = tiny_config(((2, 2),), base="gtdb40-stream")
    cache = bench_run.cache_root(tiny_root)
    genomes, tax = bench_run.load_genomes(cfg, cache)
    db_dir, _ = bench_run.program_db(cfg, genomes, tax, cache)
    budget = (16 * load_index(db_dir).size / 3.5) * 2 / (1 << 30)
    seen = []
    measure = bench_run.measure

    def keep(run, state):
        measure(run, state)
        clf = run.clf
        seen.append((clf._streaming, clf._n_ranges, clf.params.hbm_budget_gb,
                     clf.range_stats()["sweeps"]))

    monkeypatch.setattr(bench_run, "measure", keep)
    res = bench_run.run_cell(
        catalog.benchmark(), CELL, 2 ** 31 + 77, 1.0, True, device="cpu",
        root=tiny_root, cfg=cfg,
        traffic=tiny_traffic("stream-paired150",
                             params={"hbm_budget_gb": budget}))
    line = json.loads(json.dumps(res))
    assert line["correct"], line["checks"]
    assert line["checks"]["mismatched_reads"]["value"] == 0
    streaming, n_ranges, hbm_gb, sweeps = seen[0]
    assert streaming and n_ranges == 4 and hbm_gb == budget and sweeps > 0
    names = set(line["metrics"])
    assert {"range_upload_ms", "range_gb"} <= names
    # the paired flow's host spans and the set-up's, as in paired150
    assert {"input_ms", "prep_ms", "extract_ms", "probe_ms", "paths_ms",
            "db_load_s", "layout_s"} <= names
    # no card: no device time, no staging, no copies
    assert not names & {"range_upload_device_ms", "range_upload_roofline",
                        "range_stage_ms", "range_wait_ms"}
    assert line["metrics"]["range_gb"]["unit"] == "GB"
