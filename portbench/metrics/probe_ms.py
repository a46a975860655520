"""probe_ms: host ms a batch in the program's `probe` span (the enqueue
of the index probe, ops/match_torch, nested in `dispatch`), the span
total over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("probe")
