"""prep_ms: host ms a batch in the program's `prep` span (crop, right-align
and the copies of the reads to the device, nested in `dispatch`), the
span total over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("prep")
