"""range_upload_ms: host ms a batch in the program's `upload` spans in
the window, over the batches completed there (both outside the traced
slice).  The set-up's `upload` span lies before the window, so on a
streamed index these are the range uploads of the sweeps
(_RangeStream.upload: staging, the wait for a staging buffer and the
enqueue of the host-to-device copies)."""


def read(run):
    return run.stage_per_batch("upload")
