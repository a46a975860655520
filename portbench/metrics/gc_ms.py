"""gc_ms: host ms a batch in the program's `gc` spans (each collection of
Python's garbage collector, from the classifier's gc hook), the span
total over the batches completed in the window.  Inclusive: the same
time also lies inside the stage each collection interrupted."""


def read(run):
    return run.stage_per_batch("gc")
