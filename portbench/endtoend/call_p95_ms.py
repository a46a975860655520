"""call_p95_ms: the 95th percentile of the wall ms of every
Classifier.classify_batch call in the window (a call ends when it has
returned its records)."""

import numpy as np


def read(run):
    ms = [m for _, m in run.win["calls"]]
    return float(np.percentile(ms, 95)) if ms else None
