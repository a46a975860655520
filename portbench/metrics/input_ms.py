"""input_ms: host ms a batch in the program's `input` stage (parse and
pad, io/native_reader.py through Classifier._read_batches_native),
the stage total over the batches completed in the window."""


def read(run):
    return run.stage_per_batch("input")
