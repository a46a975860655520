"""redundancy_device_ms: device ms a batch of the operations launched in
the program's `redundancy` span (its innermost stage; spans.py), over
the batches completed in the traced slice."""

from portbench import spans


def read(run):
    return spans.owned_ms(run, "redundancy")
