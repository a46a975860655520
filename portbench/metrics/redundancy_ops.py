"""redundancy_ops: device operations (kernels, copies, memsets) a batch
that the program's `redundancy` span launched, over the batches
completed in the traced slice (spans.py matches each operation to the
stage ranges by launch correlation)."""

from portbench import spans


def read(run):
    return spans.ops_within(run, "redundancy")
