"""The port's own tracing (utils/timing.StageTimer and its spans in
classify/pipeline.py and models/flagship.py), on the CPU: the phases of
the enqueue nested in `dispatch` on every flow, `pad`, the garbage
collector's `gc` span and the lifetime of its hook, the set-up spans
kept in Classifier.setup_times, one "stage:<name>" profiler range a
span while a torch profiler runs, and per-read results unchanged by
tracing.  Two tests (the `cuda` marker) run on the card: the program's
ranges and the device operations on the trace's one clock, and a
streamed index's host-to-device copies owned by its `upload` spans."""

import contextlib
import gc
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.classify.em import run_em
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index.builder import build_database as tbuild
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.parallel.sharding import make_mesh
from metabuli_work_tpu_torch.utils.timing import StageTimer

from torch_port_db import (build_db, simulate_pairs, simulate_reads,
                           write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)
PHASES = ["prep", "extract", "probe", "paths"]


class Tree(StageTimer):
    """A StageTimer that also logs each span as (id, name, parent id,
    start, seconds), in the order the spans close."""

    def __init__(self):
        super().__init__()
        self.log = []
        self._open = []

    @contextlib.contextmanager
    def stage(self, name):
        sid = len(self.log) + len(self._open)
        parent = self._open[-1] if self._open else None
        self._open.append(sid)
        before = self.totals[name]
        t0 = time.perf_counter()
        try:
            with super().stage(name):
                yield
        finally:
            self._open.pop()
            self.log.append((sid, name, parent, t0,
                             self.totals[name] - before))

    def children(self, sid, skip=("gc",)):
        return [n for _, n, p, _, _ in sorted(self.log) if p == sid
                and n not in skip]

    def ids(self, name):
        return [s for s, n, _, _, _ in sorted(self.log) if n == name]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing"))
    db = build_db(tbuild, root, "db", syncmer=False)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 20, seed=31)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    m1, m2, _ = simulate_pairs(genomes, 12, seed=32)
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2)
    return dict(root=root, db=db, reads=reads, path=path,
                pairs=(os.path.join(root, "r1.fna"),
                       os.path.join(root, "r2.fna")))


def _res(results):
    return [(q.name, bool(q.result.is_classified),
             int(q.result.classification),
             np.float32(q.result.score).view(np.int32).item(),
             dict(q.result.tax_cnt)) for q in results]


def _classifier(data, flow, monkeypatch, seq_mode=1):
    kw = dict(PARAMS, seq_mode=seq_mode)
    mesh = None
    if flow == "streamed":
        index = load_index(data["db"])
        kw["hbm_budget_gb"] = (16 * index.size / 3.5) * 2 / (1 << 30)
        monkeypatch.setenv("METABULI_STREAM_GROUP", "1")
    elif flow == "mesh":
        mesh = make_mesh(4, devices=["cpu"] * 4)
    elif flow == "device-assign":
        monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    elif flow == "host-match":
        kw["min_cons_cnt"] = 1
    clf = Classifier(data["db"], ClassifyParams(**kw), mesh=mesh,
                     device="cpu" if mesh is None else None)
    assert clf._streaming == (flow == "streamed")
    assert clf._device_assign == (flow == "device-assign")
    assert (clf.mesh is not None and clf.mesh.shape == {"dp": 2, "db": 2}) \
        == (flow == "mesh")
    return clf


@pytest.mark.parametrize("flow,phases", [
    ("resident", PHASES), ("streamed", PHASES), ("mesh", PHASES),
    ("device-assign", PHASES + ["assign"]),
    ("host-match", ["prep", "extract", "probe"])])
def test_dispatch_phases_once_a_dispatch(data, flow, phases, monkeypatch):
    """Each dispatch holds each phase once, in order, directly inside
    it (a streamed probe holds its range uploads)."""
    clf = _classifier(data, flow, monkeypatch)
    clf.timer = Tree()
    clf.classify_file(data["path"])
    t = clf.timer
    dispatches = t.ids("dispatch")
    assert len(dispatches) >= 3
    for d in dispatches:
        assert t.children(d) == phases
    for name in phases:
        assert t.counts[name] == len(dispatches)
    if flow == "streamed":
        for p in t.ids("probe"):
            assert t.children(p) == ["upload"] * clf._n_ranges


def test_pad_once_a_call(data):
    clf = Classifier(data["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     device="cpu")
    clf.timer = Tree()
    seqs = [r.tobytes().decode() for r in data["reads"]]
    for k in range(3):
        batch = seqs[8 * k:8 * k + 8]
        clf.classify_batch([f"r{i}" for i in range(len(batch))], batch)
    t = clf.timer
    assert t.counts["pad"] == 3 == t.counts["dispatch"]
    assert all(p is None for _, n, p, _, _ in t.log if n == "pad")


def test_gc_span_and_hook_lifetime(data, monkeypatch):
    clf = Classifier(data["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     device="cpu")
    clf.timer = Tree()
    prep = clf._prep_mates

    def collecting(*a):
        gc.collect()
        return prep(*a)

    monkeypatch.setattr(clf, "_prep_mates", collecting)
    clf.classify_file(data["path"])
    t = clf.timer
    gc_parents = {p for _, n, p, _, _ in t.log if n == "gc"}
    assert t.counts["gc"] >= 3 and set(t.ids("prep")) <= gc_parents
    # one hook a classifier, gone with it
    del clf, t, prep, collecting
    monkeypatch.undo()
    gc.collect()
    n = len(gc.callbacks)
    index = load_index(data["db"])
    for _ in range(20):
        c = Classifier.from_memory(index, ClassifyParams(seq_mode=1,
                                                         **PARAMS),
                                   device="cpu")
        assert len(gc.callbacks) == n + 1
        del c
    gc.collect()
    assert len(gc.callbacks) == n


def test_setup_times_survive_the_timer(data):
    clf = Classifier(data["db"], ClassifyParams(seq_mode=2, **PARAMS),
                     device="cpu")
    clf.timer = StageTimer()
    assert set(clf.setup_times) == {"db_load", "layout", "upload"}
    assert all(s > 0 for s in clf.setup_times.values())
    mem = Classifier.from_memory(load_index(data["db"]),
                                 ClassifyParams(seq_mode=2, **PARAMS),
                                 device="cpu")
    assert set(mem.setup_times) == {"layout", "upload"}


EM_STEPS = ["em_map", "em_iter", "em_reclassify"]


def test_em_spans_nested(data, tmp_path):
    """run_em opens `em` on the classifier's timer, outside every other
    span, with its three steps nested in it in order, once a pass."""
    clf = Classifier(data["db"], ClassifyParams(seq_mode=1, em=True,
                                                **PARAMS), device="cpu")
    results = clf.classify_file(data["path"])
    clf.timer = Tree()
    for k in range(2):
        st = run_em(results, clf, str(tmp_path), f"job{k}")
        assert st["mappings"] >= st["mapped"] > 0
    t = clf.timer
    ems = t.ids("em")
    assert len(ems) == 2
    for e in ems:
        assert t.children(e) == EM_STEPS
        assert [p for s, _, p, _, _ in t.log if s == e] == [None]
    for name in EM_STEPS:
        assert t.counts[name] == 2
    assert t.totals["em"] >= sum(t.totals[n] for n in EM_STEPS)


def test_cli_print_timers_lists_em(data, tmp_path, capsys):
    """classify --em --print-timers prints the timer after the EM pass,
    so its table lists the four EM spans."""
    out = str(tmp_path / "out")
    assert tcli.main(["classify", data["path"], data["db"], out, "job",
                      "--seq-mode", "1", "--batch-size", "8", "--em",
                      "--print-timers", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    table = {ln.split("\t")[0]: ln for ln in
             lines[lines.index("stage\ttotal_s\tcalls\tper_call_ms"):]}
    for name in ["em"] + EM_STEPS:
        assert table[name].split("\t")[2] == "1", name
    assert {"score", "dispatch"} <= set(table)
    assert os.path.exists(os.path.join(out, "job_EM_report.tsv"))


@pytest.fixture(scope="module")
def traced(data):
    """Paired reads classified untraced, then again under a CPU torch
    profiler, with the spans and the profiler's stage ranges."""
    params = ClassifyParams(seq_mode=2, **PARAMS)
    clf = Classifier(data["db"], params, device="cpu")
    plain = _res(clf.classify_file(*data["pairs"]))
    # the first profile of a process imports for seconds (the ranges of
    # the collections it causes go unrecorded) and the first range pays
    # its op's lookup: both once, before the profile that is compared
    with profile(activities=[ProfilerActivity.CPU]):
        with StageTimer().stage("warm"):
            pass
    clf.timer = Tree()
    # collections only where asked for (one a dispatch, in `prep`): one
    # the interpreter starts in a range's own bookkeeping would lie
    # inside the range and outside the span
    prep = clf._prep_mates

    def collecting(*a):
        gc.collect(0)
        return prep(*a)

    clf._prep_mates = collecting
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = _res(clf.classify_file(*data["pairs"]))
            spans = list(clf.timer.log)     # closed under the profiler
    finally:
        gc.enable()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("stage:"):
            ranges.setdefault(e.name()[6:], []).append(
                (e.start_ns(), (e.end_ns() - e.start_ns()) / 1e9))
    return dict(plain=plain, got=got, spans=spans, ranges=ranges)


def test_results_unchanged_by_tracing(traced):
    assert traced["got"] == traced["plain"]
    assert sum(r[1] for r in traced["got"]) >= 8


def test_one_profiler_range_a_span(traced):
    ranges = traced["ranges"]
    spans = {}
    for _, n, _, t0, s in traced["spans"]:
        spans.setdefault(n, []).append((t0, s))
    assert set(spans) == set(ranges)
    assert set(PHASES) | {"dispatch", "input", "gc", "score"} <= set(spans)
    for name, own in spans.items():
        got = sorted(ranges[name])
        assert len(got) == len(own), name
        for (_, s), (_, r) in zip(sorted(own), got):
            assert abs(r - s) <= 2e-4, (name, r, s)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_probe_ops_on_the_ranges_clock(card, data):
    """On the card: every device operation launched inside a
    stage:probe range starts at or after that range's start, on the
    trace's one timeline.  The profile is a short one (a few hundred
    ms): over seconds the device's timestamps can drift from the host's
    on the card's machine (PERF.md section 5), which is why
    portbench/spans.py matches operations to stages by launch
    correlation, not by time."""
    clf = Classifier(data["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     device="cuda")
    clf.classify_file(data["path"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clf.classify_file(data["path"])
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    ev = list(prof.profiler.kineto_results.events())
    cpu = [e for e in ev if e.device_type() != DeviceType.CUDA]
    probes = [e for e in cpu if e.name() == "stage:probe"]
    # launchers: operators and ranges, the host events with no link of
    # their own (a runtime event links to its operator; its id may repeat)
    by_id = {e.correlation_id(): e for e in cpu
             if e.correlation_id() and not e.linked_correlation_id()}
    checked = 0
    for d in ev:
        if d.device_type() != DeviceType.CUDA \
                or d.name().startswith("stage:"):
            continue
        host = by_id.get(d.linked_correlation_id())
        if host is None:
            continue
        for r in probes:
            if r.start_thread_id() == host.start_thread_id() \
                    and r.start_ns() <= host.start_ns() <= r.end_ns():
                assert d.start_ns() >= r.start_ns(), \
                    (d.name(), d.start_ns() - r.start_ns(), host.name())
                checked += 1
    assert len(probes) >= 3 and checked >= len(probes)


@pytest.mark.cuda
def test_streamed_copies_owned_by_upload(card, data, monkeypatch):
    """On the card, under a profiler: a streamed classifier (4 ranges,
    one batch a sweep) launches each range's two host-to-device copies
    inside its `upload` span, their innermost stage, and nothing else
    there; each `upload` range holds one `range_wait` and one
    `range_stage` range."""
    index = load_index(data["db"])
    monkeypatch.setenv("METABULI_STREAM_GROUP", "1")
    clf = Classifier(data["db"], ClassifyParams(
        seq_mode=1, hbm_budget_gb=(16 * index.size / 3.5) * 2 / (1 << 30),
        **PARAMS), device="cuda")
    assert clf._streaming and clf._n_ranges == 4
    clf.classify_file(data["path"])
    sweeps = clf._ranges.stats()["sweeps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clf.classify_file(data["path"])
        torch.cuda.synchronize()
    sweeps = clf._ranges.stats()["sweeps"] - sweeps
    from torch.autograd import DeviceType

    ev = list(prof.profiler.kineto_results.events())
    cpu = [e for e in ev if e.device_type() != DeviceType.CUDA]
    stages = [e for e in cpu if e.name().startswith("stage:")]

    def inside(e, r):
        return r.start_thread_id() == e.start_thread_id() \
            and r.start_ns() <= e.start_ns() <= r.end_ns()

    def innermost(e):
        held = [r for r in stages if inside(e, r)]
        return max(held, key=lambda r: r.start_ns()).name()[6:] \
            if held else None

    uploads = [r for r in stages if r.name() == "stage:upload"]
    assert sweeps >= 3 and len(uploads) == sweeps * 4
    for u in uploads:
        within = sorted(r.name() for r in stages if r is not u
                        and r.name() != "stage:gc" and inside(r, u))
        assert within == ["stage:range_stage", "stage:range_wait"]
    by_id = {e.correlation_id(): e for e in cpu
             if e.correlation_id() and not e.linked_correlation_id()}
    owned = []
    for d in ev:
        if d.device_type() != DeviceType.CUDA \
                or d.name().startswith("stage:"):
            continue
        host = by_id.get(d.linked_correlation_id())
        if host is not None and innermost(host) == "upload":
            owned.append(d.name())
    assert len(owned) == 2 * len(uploads)
    assert all(n.startswith("Memcpy HtoD") for n in owned), set(owned)
