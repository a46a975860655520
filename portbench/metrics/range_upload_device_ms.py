"""range_upload_device_ms: device ms a batch of the operations launched
in the program's `upload` spans (their innermost stage; spans.py): on a
streamed index the host-to-device copies of the ranges, over the
batches completed in the traced slice."""

from portbench import spans


def read(run):
    return spans.owned_ms(run, "upload")
