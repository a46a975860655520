"""score_ms: host ms a batch in the program's `score` stage (host
scoring, classify/taxonomer_vec), the stage total over the batches
completed in the window."""


def read(run):
    return run.stage_per_batch("score")
