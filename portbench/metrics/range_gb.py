"""range_gb: GB of the index uploaded a batch: the program's `upload`
spans in the window (outside the traced slice, as the stage metrics
count them) times the bytes of one range, over the batches completed
there.  The bytes of a range are the `range_bytes` of the classifier's
range_stats(); a program without them reads nothing."""


def range_bytes(run):
    """Bytes of one range of the classifier's streamed index, or None."""
    stats = getattr(run.clf, "range_stats", lambda: None)()
    return None if stats is None else stats.get("range_bytes")


def uploads(run, t0, t1, kept=lambda t: True):
    """The `upload` spans that start in [t0, t1] and are kept."""
    return sum(1 for n, a, _ in run.clf.timer.spans
               if n == "upload" and t0 <= a <= t1 and kept(a))


def read(run):
    b = range_bytes(run)
    w = run.win
    n = uploads(run, w["t0"], w["t1"], run._kept)
    batches = sum(1 for t in w["batch_ends"]
                  if w["t0"] <= t <= w["t1"] and run._kept(t))
    if not b or not n or not batches:
        return None
    return n * b / batches / 1e9
