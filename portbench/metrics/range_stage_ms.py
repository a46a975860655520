"""range_stage_ms: host ms a batch in the program's `range_stage` spans
(a range's copy from the host-resident index into a pinned staging
buffer, nested in `upload`), over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("range_stage")
