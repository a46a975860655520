"""The readers of the program's own spans (spans.py and the metrics that
read it, the host-side span readers and the set-up readers), on a
synthetic event list and synthetic runs."""

from types import SimpleNamespace

import pytest

from portbench import catalog, spans, trace
from portbench import run as bench_run


def _ev(name, start, end, device=False, id=0, link=0, stream=7,
        thread=1):
    return trace.Record(name, device, start, end, id, link, stream, thread)


def _events():
    # a 1,000-us slice.  On the host: the benchmark's stage:dispatch
    # around the program's (0-500), with prep, extract, probe and paths
    # inside it, a path-DP call inside paths; then score (500-1000) with
    # a collection inside it.  Each host op launches one device op.
    return [
        _ev(trace.MARK_START, 0, 0), _ev(trace.MARK_END, 1000, 1000),
        _ev("aten::mul", -50, -40, id=15),            # before the slice
        _ev("stage:dispatch", 0, 500, id=1),
        _ev("stage:dispatch", 1, 499, id=2),
        _ev("stage:prep", 2, 50, id=3), _ev("aten::copy_", 10, 20, id=10),
        _ev("stage:extract", 50, 150, id=4), _ev("aten::mul", 60, 70, id=11),
        _ev("stage:probe", 150, 300, id=5), _ev("aten::index", 160, 170,
                                                 id=12),
        _ev("stage:paths", 300, 490, id=6),
        _ev(trace.DP_RANGE, 400, 450, id=7), _ev("aten::fill_", 410, 415,
                                                  id=13),
        _ev("stage:score", 500, 1000, id=8), _ev("stage:gc", 700, 720, id=9),
        _ev("aten::add", 600, 610, id=14),
        # the same stage names on another thread hold nothing of thread 1
        _ev("stage:probe", 0, 1000, id=20, thread=2),
        # a runtime event links to its operator; its own id repeats
        # another operator's and is no launcher
        _ev("cudaLaunchKernel", 61, 65, id=12, link=11, thread=99),
        # device operations
        _ev("Memcpy HtoD", 100, 110, True, link=10),
        _ev("k_ext", 120, 200, True, link=11),
        _ev("k_gather", 200, 400, True, link=12),
        _ev("k_fill", 420, 425, True, link=13),
        _ev("k_dp", 430, 530, True),                   # no launch seen
        _ev("k_add", 620, 640, True, link=14),
        _ev("k_other", 650, 660, True, stream=9),      # none before it
        _ev("k_late", 990, 1015, True, link=12),       # past the slice
        _ev("k_early", 5, 15, True, link=15),          # launched before
        # GPU-side annotations of the ranges: never operations
        _ev("stage:probe", 200, 400, True), _ev(trace.DP_RANGE, 420, 530,
                                                True),
    ]


def _run(events=None, ends=(99.5, 100.5, 101.5, 102.5)):
    sl = SimpleNamespace(events=_events() if events is None else events,
                         t_start=100.0, t_end=102.0)
    return SimpleNamespace(slice=sl, win={"batch_ends": list(ends)})


# the synthetic device operations by their (distinct) durations in us
DUR = {10: "Memcpy HtoD", 80: "k_ext", 200: "k_gather", 5: "k_fill",
       100: "k_dp", 20: "k_add", 25: "k_late"}


def _owners():
    """{device op name: its stages} of the slice's operations."""
    ops = spans.device_ops(_events())
    assert len({d for d, _ in ops}) == len(ops)
    return {DUR[d]: st for d, st in ops}


def test_owner_is_the_innermost_stage():
    own = _owners()
    assert own["Memcpy HtoD"] == ("dispatch", "prep")
    assert own["k_ext"] == ("dispatch", "extract")
    assert own["k_gather"] == ("dispatch", "probe")
    assert own["k_fill"] == ("dispatch", "paths")   # inside the DP range
    assert own["k_add"] == ("score",)               # outside dispatch
    # the ranges' GPU-side annotations are no operations; k_early was
    # launched before the slice, k_other has no launch seen and nothing
    # linked before it on its stream
    assert set(own) == set(DUR.values())


def test_nested_same_name_counted_once():
    chains = {k: st for k, (_, st) in spans._launches(_events()).items()}
    assert chains[2] == ("dispatch",)
    assert chains[11] == ("dispatch", "extract")
    assert chains[9] == ("score", "gc")
    # six operations launched inside dispatch (k_dp by stream order,
    # k_late by its launch in probe), two batches end in the slice
    assert spans.ops_within(_run(), "dispatch") == pytest.approx(3.0)


def test_no_launch_follows_its_stream():
    assert _owners()["k_dp"] == ("dispatch", "paths")     # after k_fill


def test_in_the_slice_by_launch():
    """An operation launched inside the slice counts whole, wherever the
    device's clock puts it; one launched before the slice does not."""
    assert _owners()["k_late"] == ("dispatch", "probe")
    assert len(spans.device_ops(_events())) == len(DUR)     # no k_early


def test_device_ms_a_batch_in_the_slice():
    run = _run()
    assert spans.slice_batches(run) == 2
    assert catalog.metric_reader("extract_device_ms").read(run) == \
        pytest.approx(80 / 1e3 / 2)
    # k_gather and all of k_late
    assert catalog.metric_reader("probe_device_ms").read(run) == \
        pytest.approx(225 / 1e3 / 2)
    assert catalog.metric_reader("paths_device_ms").read(run) == \
        pytest.approx(105 / 1e3 / 2)
    assert catalog.metric_reader("dispatch_ops").read(run) == \
        pytest.approx(3.0)
    # more batches in the slice, less a batch
    run = _run(ends=(100.1, 100.2, 100.3, 100.4))
    assert catalog.metric_reader("probe_device_ms").read(run) == \
        pytest.approx(225 / 1e3 / 4)


def test_nothing_to_read_is_none():
    readers = [catalog.metric_reader(n) for n in (
        "dispatch_ops", "extract_device_ms", "probe_device_ms",
        "paths_device_ms")]
    for run in (SimpleNamespace(slice=None, win={"batch_ends": [1.0]}),
                _run(events=[]),
                _run(events=[e for e in _events()
                             if e.name != trace.MARK_END]),
                _run(ends=(1.0, 200.0)),
                _run(events=[e for e in _events()
                             if not e.name.startswith("stage:")])):
        for r in readers:
            assert r.read(run) is None


def _host_run(spans_, ends, slice_=None):
    """A run of the harness holding a timer's spans and batch ends."""
    run = bench_run.Run.__new__(bench_run.Run)
    run.slice = slice_
    run.win = {"t0": 0.0, "t1": 100.0, "batch_ends": list(ends)}
    run.clf = SimpleNamespace(timer=SimpleNamespace(spans=list(spans_)))
    return run


def test_host_span_readers():
    sp = [("dispatch", 1.0, 1.05), ("prep", 1.0, 1.002),
          ("extract", 1.002, 1.01), ("probe", 1.01, 1.02),
          ("paths", 1.02, 1.05), ("gc", 1.03, 1.031), ("pad", 0.9, 0.95),
          ("prep", 50.0, 50.004), ("gc", 50.0, 50.001)]
    run = _host_run(sp, ends=(2.0, 60.0))
    for name, ms in (("prep_ms", 3.0), ("extract_ms", 4.0),
                     ("probe_ms", 5.0), ("paths_ms", 15.0),
                     ("gc_ms", 1.0), ("pad_ms", 25.0)):
        assert catalog.metric_reader(name).read(run) == \
            pytest.approx(ms), name
    # spans inside the traced slice are left out, and so are its batches
    sl = SimpleNamespace(excluded=lambda t: 40.0 <= t <= 70.0)
    run = _host_run(sp, ends=(2.0, 60.0), slice_=sl)
    assert catalog.metric_reader("prep_ms").read(run) == pytest.approx(2.0)
    assert catalog.metric_reader("pad_ms").read(_host_run(
        [("prep", 1.0, 1.1)], ends=(2.0,))) is None


def test_setup_readers():
    clf = SimpleNamespace(setup_times={"db_load": 3.5, "layout": 7.25,
                                       "upload": 1.5})
    run = SimpleNamespace(clf=clf)
    assert catalog.metric_reader("db_load_s").read(run) == 3.5
    assert catalog.metric_reader("layout_s").read(run) == 7.25
    assert catalog.metric_reader("upload_s").read(run) == 1.5
    # a program without the set-up spans (a classifier from memory has no
    # db_load; an older program keeps none)
    run = SimpleNamespace(clf=SimpleNamespace(setup_times={"layout": 1.0}))
    assert catalog.metric_reader("db_load_s").read(run) is None
    run = SimpleNamespace(clf=SimpleNamespace())
    for n in ("db_load_s", "layout_s", "upload_s"):
        assert catalog.metric_reader(n).read(run) is None
