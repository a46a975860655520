"""path_dp_roofline: the path-DP calls' share of their roofline, in %.

Over the calls of ops.dp_cuda.path_dp_blocked in the traced slice: the
least time of the bytes each call's shapes need (roofline.path_dp_bytes)
at the card's memory rate, over the device time of every kernel
launched inside those calls (matched by launch correlation to the
benchmark's record_function range around each call).  Taken at the
entry, it reads the same work whatever kernel implements it."""

from portbench import roofline


def read(run):
    tr = run.trace
    if not tr or not run.dp_shapes or not tr["dp_device_s"]:
        return None
    if len(tr["dp_device_s"]) != len(run.dp_shapes):
        return None
    device_s = sum(tr["dp_device_s"])
    rate = roofline.hbm_rate(run.kind)
    if device_s <= 0 or rate is None:
        return None
    least_s = sum(roofline.path_dp_bytes(*s) for s in run.dp_shapes) / rate
    return 100.0 * least_s / device_s
