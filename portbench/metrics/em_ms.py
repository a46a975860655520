"""em_ms: host ms a batch in the program's `em` spans (classify/em.run_em,
the EM pass after each classify_file pass of classify --em), the span
total over the batches completed in the window.  Unlike the stage
metrics (Run.stage_per_batch) it keeps the traced slice's batches: the
EM entry stops the slice before each EM pass, so no EM span lies in it,
and leaving out its batches would raise the reading.  A program with no
such span reads nothing."""


def per_batch(run, name):
    """ms a batch of the window's `name` spans, over all its batches."""
    w = run.win
    spans = [b - a for n, a, b in run.clf.timer.spans
             if n == name and w["t0"] <= a <= w["t1"]]
    batches = sum(1 for t in w["batch_ends"] if w["t0"] <= t <= w["t1"])
    if not spans or not batches:
        return None
    return 1e3 * sum(spans) / batches


def read(run):
    return per_batch(run, "em")
