"""paths_device_ms: device ms a batch of the operations launched in the
program's `paths` span (its innermost stage; spans.py; the path-DP
kernels, which show no launch, by stream order), over the batches
completed in the traced slice."""

from portbench import spans


def read(run):
    return spans.owned_ms(run, "paths")
