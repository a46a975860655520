"""The reduction of a traced slice and the roofline reader, on a
synthetic event list."""

from types import SimpleNamespace

import pytest

from portbench import roofline, trace
from portbench.metrics import path_dp_roofline


def _ev(name, start, end, device=False, id=0, link=0, stream=7,
        thread=1):
    return trace.Record(name, device, start, end, id, link, stream, thread)


def _events():
    # a 1,000-us slice: kernels at 100-300 (two overlapping), 500-600,
    # a copy at 900-950; the host in `dispatch` over 0-400, in `score`
    # over 400-1000 with `fetch` inside it at 650-850
    return [
        _ev(trace.MARK_START, 0, 0), _ev(trace.MARK_END, 1000, 1000),
        _ev("stage:dispatch", 0, 400), _ev("stage:score", 400, 1000),
        _ev("stage:fetch", 650, 850),
        # a path-DP call on the host at 40-60: its fill op (id 5)
        # launches k_b; the kernel after it on the stream (k_a at 100)
        # has no link (launched where the profiler sees no launch)
        _ev(trace.DP_RANGE, 40, 60, id=4), _ev("aten::fill_", 45, 50, id=5),
        _ev("aten::mul", 70, 80, id=6),
        _ev("k_fill", 90, 95, True, link=5), _ev("k_a", 100, 250, True),
        _ev("k_b", 200, 300, True, link=6), _ev("k_a", 500, 600, True),
        _ev("Memcpy DtoH", 900, 950, True, link=6),
        _ev(trace.DP_RANGE, 480, 490, True),      # its device annotation
        _ev("stage:score", 400, 1000, True),
    ]


def test_busy_and_window():
    r = trace.reduce_events(_events())
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(355e-6)      # 5 + 200 + 100 + 50


def test_device_ops_by_time():
    r = trace.reduce_events(_events())
    assert r["device_ops"][0] == ["k_a", pytest.approx(250e-6)]
    assert [n for n, _ in r["device_ops"]] == ["k_a", "k_b", "Memcpy DtoH",
                                               "k_fill"]


def test_idle_gaps_labelled_by_host_stage():
    r = trace.reduce_events(_events())
    # gaps: 0-90 (90, dispatch), 95-100 (5), 300-500 (200, score at
    # 400), 600-900 (300, fetch at 750), 950-1000 (50, score)
    assert [round(s * 1e6) for _, s in r["idle_gaps"]] == [300, 200, 90, 50,
                                                            5]
    assert r["idle_gaps"][0][0] == "fetch at 0.001 s"
    assert r["idle_gaps"][1][0].startswith("score")
    assert r["idle_gaps"][2][0].startswith("dispatch")


def test_dp_device_time_by_correlation_and_stream_order():
    # the call's own fill (5 us) and the unlinked
    # kernel after it (150 us); k_a at 500 follows k_b of aten::mul,
    # which is no call's
    assert trace.reduce_events(_events())["dp_device_s"] == \
        pytest.approx([155e-6])


def test_short_name():
    assert trace.short_name("void ns::k<16, long>(char*, (anonymous "
                            "namespace)::T)") == "ns::k<16, long>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH "


def test_no_device_events_is_nothing():
    ev = [_ev(trace.MARK_START, 0, 0), _ev(trace.MARK_END, 10, 10)]
    assert trace.reduce_events(ev) is None


def test_path_dp_bytes():
    # cap 8, G 6144, W 36, block 16, compact: the byte bound recorded
    # for the warp kernel's cap-8 input, 0.01118 ms at 3.35 TB/s
    b = roofline.path_dp_bytes(8, 6144, 36, 16, True)
    assert b == 5 * 8 * 6144 * 36 * 4 + 5 * 16 * 6144 * 4 + 16 * 6144 + 4
    assert b / 3.35e12 * 1e3 == pytest.approx(0.01118, abs=5e-6)
    assert roofline.path_dp_bytes(8, 10, 10, 4, False) - \
        roofline.path_dp_bytes(8, 10, 10, 4, True) == 2 * 4 * 10 * 4


def test_roofline_reader():
    shape = (84, 6144, 36, 128, True)
    least = roofline.path_dp_bytes(*shape) / 3.35e12
    run = SimpleNamespace(trace={"dp_device_s": [4 * least, 4 * least]},
                          dp_shapes=[shape, shape],
                          kind="NVIDIA H100 80GB HBM3")
    assert path_dp_roofline.read(run) == pytest.approx(25.0)
    run.trace = {"dp_device_s": []}
    assert path_dp_roofline.read(run) is None
    run.trace, run.dp_shapes = None, []
    assert path_dp_roofline.read(run) is None
