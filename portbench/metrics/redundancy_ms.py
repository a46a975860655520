"""redundancy_ms: host ms a batch in the program's `redundancy` span (the
finish's enqueue of the best-species redundancy step,
flagship.redundancy_counts, with the upload of the best species and the
copy of the pairs home), the span total over the batches completed in
the window."""


def read(run):
    return run.stage_per_batch("redundancy")
