"""Stage timing and profiling — the package's observability layer.

Reference behavior: ad-hoc wall-clock stage prints (Classifier.cpp:
116-125, KmerMatcher.cpp:202,477) + /proc/self/stat memory reporting
(common.cpp:27-47).  Here: a StageTimer accumulating per-stage host
seconds across batches (printed as a table), process RSS sampling, and
maybe_torch_profile, a torch.profiler trace of a region (classify
--profile-dir).

StageTimer is the program's one tracer.  Classifier (classify/pipeline)
opens these spans on its `timer`:

- set-up, once per classifier (their seconds also kept in
  Classifier.setup_times): `db_load` (load_index, or the import of a
  reference-format DB), `layout` (LCA tables and the packed probe
  layout, from the pack cache or built), `upload` (the index and tables
  to the device);
- per range upload of a streamed index (the range sweep inside
  `probe`, or `long_probe` for the chunk pass): `upload`, holding on
  the card `range_wait` (the wait for the pinned staging buffer's
  previous copy) and `range_stage` (the range's copy into it); the
  host-to-device copies are launched in `upload` itself;
- per batch: `input` (classify_file's parse and pad), `pad`
  (classify_batch's padding of string reads), `dispatch` (the enqueue
  of the device step) holding `prep` (crop, right-align and the copies
  of the reads to the device), `extract`, `probe` (the index probe; the
  range sweep when streamed), `paths` (lane flips, path DP and
  compaction; on a mesh the db merge too) and, on the device-assign
  flow, `assign`; then `hdr_sync`, `retry`, `fetch`, `score`,
  `redundancy`, `redundancy_sync` (`decode+sort` on the host-match
  flow; `long_probe`, `long_score` for reads beyond the row cap);
- `gc`: each collection of Python's garbage collector (the classifier's
  gc hook), inside whatever stage it interrupted.

While a torch profiler runs (torch.profiler.profile, as
maybe_torch_profile starts it), each span is also a record_function
range named "stage:<name>" around it, on the profiler's clock, so the
device operations a span launches are matched to it by launch
correlation.  With no profiler the check is one attribute read.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch.autograd.profiler as _autograd_profiler

STAGE_PREFIX = "stage:"


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            rf = _autograd_profiler.record_function(STAGE_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if rf is not None:
                rf.__exit__(None, None, None)

    def report(self, out=None):
        lines = ["stage\ttotal_s\tcalls\tper_call_ms"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}\t{total:.3f}\t{n}\t{1000 * total / n:.1f}")
        text = "\n".join(lines)
        if out:
            with open(out, "w") as f:
                f.write(text + "\n")
        return text


def rss_gb() -> float:
    """Resident set size in GiB (reference process_mem_usage)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 30)
    except (OSError, ValueError):
        return 0.0


@contextlib.contextmanager
def maybe_torch_profile(trace_dir=None):
    """Wrap a region in a torch.profiler trace when trace_dir is given:
    CPU activity, plus CUDA activity when a card is visible; the Chrome
    trace is written to trace_dir/trace_<pid>_<ns>.json when the region
    ends.  The StageTimer spans opened inside it show as "stage:<name>"
    ranges."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
