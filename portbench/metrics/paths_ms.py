"""paths_ms: host ms a batch in the program's `paths` span (the enqueue
of the lane flips, the path DP of ops/dp_cuda and the compaction,
models/flagship.finish_stream_step, nested in `dispatch`), the span
total over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("paths")
