"""call_p50_ms: the median wall ms of the window's
Classifier.classify_batch calls (the calls of call_p95_ms)."""

import statistics


def read(run):
    ms = run.call_ms()
    return statistics.median(ms) if ms else None
