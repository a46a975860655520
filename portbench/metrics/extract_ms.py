"""extract_ms: host ms a batch in the program's `extract` span (the
enqueue of query extraction, models/flagship.extract_queries_step,
nested in `dispatch`), the span total over the batches completed in the
window."""


def read(run):
    return run.stage_per_batch("extract")
