"""dispatch_ms: host ms a batch in the program's `dispatch` stage (the
enqueue of the device step, models/flagship; retries included), the
stage total over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("dispatch")
