"""Stage timing — the package's observability layer.

Reference behavior: ad-hoc wall-clock stage prints (Classifier.cpp:
116-125, KmerMatcher.cpp:202,477) + /proc/self/stat memory reporting
(common.cpp:27-47).  Here: a StageTimer accumulating per-stage host
seconds across batches (printed as a table) and process RSS sampling.
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
