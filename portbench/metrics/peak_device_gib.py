"""peak_device_gib: torch.cuda.max_memory_allocated() over the window
(the peak statistics reset at its start), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
