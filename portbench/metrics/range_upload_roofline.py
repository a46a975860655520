"""range_upload_roofline: the range uploads' share of the host link's
peak, in %.

Over the traced slice: the `upload` spans that start in it times the
bytes of one range (range_gb.range_bytes), at the link's one-way peak,
over the device time of the operations whose innermost stage is
`upload` among those launched in the slice (the selection of
spans.owned_ms): on a streamed index the ranges' host-to-device copies.
Taken at _RangeStream.upload, it reads the same bytes whatever
implements the copy."""

from portbench import spans
from portbench.metrics import range_gb

# one way of the NVIDIA H100 SXM's host interface, PCIe Gen5 x16 (NVIDIA
# H100 data sheet: "PCIe Gen5: 128GB/s", both ways together)
LINK_BYTES_PER_S = 64e9


def read(run):
    sl = run.slice
    if sl is None or sl.t_start is None or sl.t_end is None:
        return None
    b = range_gb.range_bytes(run)
    n = range_gb.uploads(run, sl.t_start, sl.t_end)
    ops = spans.slice_ops(run)
    if not b or not n or not ops:
        return None
    us = sum(d for d, st in ops if st and st[-1] == "upload")
    if not us:
        return None
    least_s = n * b / LINK_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
