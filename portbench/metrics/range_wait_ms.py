"""range_wait_ms: host ms a batch in the program's `range_wait` spans
(the wait for a pinned staging buffer's previous host-to-device copy,
nested in `upload`), over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("range_wait")
