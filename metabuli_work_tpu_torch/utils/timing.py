"""Stage timing and profiling — the package's observability layer.

Reference behavior: ad-hoc wall-clock stage prints (Classifier.cpp:
116-125, KmerMatcher.cpp:202,477) + /proc/self/stat memory reporting
(common.cpp:27-47).  Here: a StageTimer accumulating per-stage host
seconds across batches (printed as a table), process RSS sampling, and
maybe_torch_profile, a torch.profiler trace of a region (classify
--profile-dir).
"""

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

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
    ends."""
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
