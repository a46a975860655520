"""What a run observes of the program, from the benchmark's side.

- RecordingTimer stands in for Classifier.timer: it keeps the
  program's own stage totals (utils/timing.StageTimer) and also each
  span's start and end, and, while the profiler runs, opens a
  record_function range "stage:<name>" around the span.
- DpCalls wraps ops.dp_cuda.path_dp_blocked (the program calls it
  through the module): while the profiler runs, each call's shapes are
  noted and the call runs inside a record_function range, so the
  kernels it launches are matched to it by launch correlation.
- Slice starts torch.profiler at a point in the window and stops it
  after `seconds`; its events stay in memory and are reduced here to
  the device's busy time, the largest device operations, the longest
  idle gaps with the host stage they fell in, and each path-DP call's
  device time.
"""

import bisect
import collections
import time

import torch

DP_RANGE = "portbench::path_dp"
MARK_START = "portbench::slice_start"
MARK_END = "portbench::slice_end"
STAGE_PREFIX = "stage:"


def recording_timer(base_cls):
    """A subclass of the program's StageTimer that records spans."""

    class RecordingTimer(base_cls):
        def __init__(self):
            super().__init__()
            self.spans = []          # (name, t0, t1) on perf_counter
            self.profiling = False

        def stage(self, name):
            inner = super().stage(name)
            rec = self

            class _Span:
                def __enter__(self):
                    self.rf = None
                    if rec.profiling:
                        self.rf = torch.profiler.record_function(
                            STAGE_PREFIX + name)
                        self.rf.__enter__()
                    self.t0 = time.perf_counter()
                    return inner.__enter__()

                def __exit__(self, *exc):
                    out = inner.__exit__(*exc)
                    rec.spans.append((name, self.t0, time.perf_counter()))
                    if self.rf is not None:
                        self.rf.__exit__(*exc)
                    return out

            return _Span()

    return RecordingTimer


class DpCalls:
    """Wraps dp_cuda.path_dp_blocked for the run; restore() undoes it."""

    def __init__(self, dp_cuda):
        self.mod = dp_cuda
        self.orig = dp_cuda.path_dp_blocked
        self.profiling = False
        self.shapes = []             # (cap, G, W, block_w, compact5)

        def wrapped(*args, **kw):
            if not self.profiling:
                return self.orig(*args, **kw)
            cap, G, W = args[0].shape
            self.shapes.append((cap, G, W, kw["block_w"],
                                kw.get("compact5", True)))
            with torch.profiler.record_function(DP_RANGE):
                return self.orig(*args, **kw)

        dp_cuda.path_dp_blocked = wrapped

    def restore(self):
        self.mod.path_dp_blocked = self.orig


class Slice:
    """Profiles from the first poll() at or after `start_at` (perf_counter)
    for `seconds`, then stops at the first poll() after that."""

    def __init__(self, start_at, seconds, hooks):
        self.start_at, self.seconds = start_at, seconds
        self.hooks = hooks           # objects with a `profiling` flag
        self.prof = None
        self.t_start = self.t_end = None
        self.events = None

    def poll(self):
        now = time.perf_counter()
        if self.prof is None and now >= self.start_at:
            self._start()
        elif self.prof is not None and self.events is None \
                and now >= self.t_start + self.seconds:
            self.stop()

    @property
    def active(self):
        return self.prof is not None and self.events is None

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        for h in self.hooks:
            h.profiling = True
        self.t_start = time.perf_counter()
        with torch.profiler.record_function(MARK_START):
            pass

    def stop(self):
        if not self.active:
            return
        with torch.profiler.record_function(MARK_END):
            pass
        for h in self.hooks:
            h.profiling = False
        self.prof.stop()
        self.events = records(self.prof)
        self.t_end = time.perf_counter()

    def excluded(self, t):
        """Whether host time t falls in the profiled slice (its parse
        included), which the stage and call metrics leave out."""
        return self.t_start is not None and \
            self.t_start <= t <= (self.t_end or float("inf"))


def warm_profiler():
    """One tiny profile, so the first slice does not pay the profiler's
    start-up inside the window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        x = torch.ones(16, device="cuda" if torch.cuda.is_available()
                       else "cpu")
        (x + 1).sum().item()


Record = collections.namedtuple(
    "Record", "name device start end id link stream thread")


def records(prof):
    """The profiler's raw events as Records (times in us from the
    trace's start): a device operation's `link` is the correlation id
    (`id`) of the host op that launched it, 0 where the profiler saw no
    launch; `stream` is a device operation's stream."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [Record(k.name(), k.device_type() == DeviceType.CUDA,
                   (k.start_ns() - t0) / 1e3, (k.end_ns() - t0) / 1e3,
                   k.correlation_id(), k.linked_correlation_id(),
                   k.device_resource_id(), k.start_thread_id())
            for k in res.events()]


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def reduce_events(events, top=10):
    """From the slice's profiler events (Records, times in us):
    {"window_s", "busy_s", "device_ops" [[name, s]], "idle_gaps"
    [[label, s]], "dp_device_s" [s a path-DP call]}, or None when the
    slice holds no device operation."""
    marks = {e.name: e.start for e in events
             if e.name in (MARK_START, MARK_END) and not e.device}
    if MARK_START not in marks or MARK_END not in marks:
        return None
    w0, w1 = marks[MARK_START], marks[MARK_END]
    ranges = (DP_RANGE, MARK_START, MARK_END)
    dev = [e for e in events if e.device
           and e.name not in ranges and not e.name.startswith(STAGE_PREFIX)
           and e.end > w0 and e.start < w1]
    if not dev:
        return None
    ivals = [(max(e.start, w0), min(e.end, w1))
             for e in dev]
    busy = _union(ivals)
    busy_us = sum(t - s for s, t in busy)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(short_name(n), us) for n, us in ops]
    # idle gaps between busy intervals, labelled by the host stage
    # (innermost stage range) open at the gap's midpoint
    stages = sorted(((e.start, e.end,
                      e.name[len(STAGE_PREFIX):]) for e in events
                     if not e.device
                     and e.name.startswith(STAGE_PREFIX)))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((t - s, s) for s, t in zip(edges[0::2], edges[1::2])
                   if t > s), reverse=True)[:top]
    labelled = []
    for us, s in gaps:
        mid = s + us / 2
        label = "outside stages"
        for a, b, name in stages:
            if a > mid:
                break
            if b >= mid:
                label = name
        labelled.append([f"{label} at {(s - w0) / 1e6:.3f} s", us / 1e6])
    dp_s, unlinked = _dp_device_seconds(events, dev)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": labelled,
            "dp_device_s": dp_s,
            "unlinked": sorted(unlinked.items(), key=lambda kv: -kv[1])}


def short_name(name, limit=200):
    """A kernel's name without its parameter list and leading `void`."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:limit]


def _dp_device_seconds(events, dev):
    """Device seconds of each path-DP call (each DP_RANGE on the host, in
    order).  A device operation belongs to a call when the host op that
    launched it (its linked correlation id) lies inside the call's
    range.  A kernel launched where the profiler sees no launch (a
    library's own CUDA runtime, as the program's ctypes kernels are)
    has no link; it belongs to the call of the linked operation just
    before it on its stream, since a stream runs in launch order.
    Returns the seconds a call and the unlinked operations by name."""
    cpu = sorted((e for e in events if not e.device),
                 key=lambda e: e.start)
    starts = [e.start for e in cpu]
    ranges = [e for e in cpu if e.name == DP_RANGE]
    owner = {}
    for k, r in enumerate(ranges):
        i = bisect.bisect_left(starts, r.start)
        while i < len(cpu) and cpu[i].start <= r.end:
            e = cpu[i]
            if e.thread == r.thread and e.end <= r.end:
                owner[e.id] = k
            i += 1
    linked_ids = {e.id for e in cpu}
    out = [0.0] * len(ranges)
    last, unlinked = {}, {}
    for e in sorted(dev, key=lambda e: e.start):
        stream, link = e.stream, e.link
        dur = (e.end - e.start) / 1e6
        if link in owner:
            k = last[stream] = owner[link]
        elif link and link in linked_ids:
            k = last[stream] = None
        else:
            k = last.get(stream)
            unlinked[e.name] = unlinked.get(e.name, 0) + 1
        if k is not None:
            out[k] += dur
    return out, unlinked
