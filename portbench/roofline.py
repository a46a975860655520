"""The table of peaks and the path DP's least bytes (frozen copy of the
byte term of chip_smoke.kernel_bound_ms).

One call of ops.dp_cuda.path_dp_blocked over [cap, G, W] candidates
must read five int32 candidate fields once (species, DNA code, packed
hammings, hamming sum, position) and write its blocked path columns
(n_cols x block_w x G int32, n_cols 5 in the compact layout, else 7),
their valid flags (block_w x G bytes) and the overflow count (4 bytes)
once.  The compare term of kernel_bound_ms is left out: it was at most
0.3% of the byte term on every input captured so far, so bytes bound
the call.
"""

# by the name torch.cuda.get_device_name() gives: NVIDIA H100 SXM (data
# sheet; at the full 700-W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def path_dp_bytes(cap, G, W, block_w, compact5):
    n_cols = 5 if compact5 else 7
    return 5 * cap * G * W * 4 + n_cols * block_w * G * 4 + block_w * G + 4


def hbm_rate(kind):
    """The card's memory rate, or None for a card not in the table."""
    return PEAKS[kind]["hbm_bytes_per_s"] if kind in PEAKS else None
