"""pad_ms: host ms a call in the program's `pad` span (classify_batch
padding its string reads into rows), the span total over the calls
completed in the window."""


def read(run):
    return run.stage_per_batch("pad")
