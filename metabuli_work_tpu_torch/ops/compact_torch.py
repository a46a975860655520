"""Device-side match compaction for the host-match flow.

The probe produces [N, cap] candidate tensors, mostly empty.  Every
match is packed into six int32 words, valid rows are compacted to the
front with a prefix sum + scatter (O(N)), and ONE stacked [6, N*cap]
tensor comes back so the host pays a single transfer for the `count`
prefix.  The host decodes fields with vectorized shifts and applies the
reference's compareMatches total order (qid, species, frame, pos,
hamming, dnaEncoding — reference src/commons/KmerMatcher.cpp:1149-1166)
with one np.lexsort on the small compacted set.

Packed int32 columns:
  0 qid | 1 species | 2 (frame << 27) | (ham << 19) | rh(16->bits 3..18)
  3 pos | 4 dna_enc | 5 taxid
"""

import numpy as np
import torch

N_COLS = 6


def compact_and_sort(out, q_pos, q_frames, q_sids):
    """out: dict from match_kmers ([N, cap] query-major); q_*: [N] query
    annotation.

    Returns (packed int32 [N_COLS, N*cap], count int32): match rows
    compacted to the front of each column in (query, cap) order.  Only
    the first `count` columns carry meaning; the rest hold 0.  Every
    destination is written once (unselected rows go to one extra slot
    that is cut off), so the result does not depend on scatter order.
    """
    sel = out["sel"]
    N, cap = sel.shape
    total = N * cap

    def bc(x):
        return x[:, None].expand(N, cap).reshape(total)

    flat = lambda x: x.reshape(total)
    self = flat(sel)
    meta = (bc(q_frames).to(torch.int32) << 27) \
        | (flat(out["hamming"]) << 19) | (flat(out["rh"]) << 3)
    cols = [bc(q_sids), flat(out["species"]), meta, bc(q_pos),
            flat(out["dna_enc"]), flat(out["taxid"])]

    dest = torch.cumsum(self.to(torch.int64), 0) - 1
    dest = torch.where(self, dest, total)
    packed = torch.zeros((N_COLS, total + 1), dtype=torch.int32,
                         device=sel.device)
    for i, arr in enumerate(cols):
        packed[i].scatter_(0, dest, torch.where(self, arr.to(torch.int32), 0))
    return packed[:, :total], self.sum().to(torch.int32)


def decode_matches(packed, match_dtype):
    """numpy decode of device-packed matches -> MATCH_DTYPE record array."""
    p = np.asarray(packed)
    m = np.zeros(p.shape[1], dtype=match_dtype)
    m["qid"] = p[0]
    m["species"] = p[1]
    # the meta word is u32 bits in an int32 column: widen and mask so the
    # shifts below are logical
    meta = p[2].astype(np.int64) & 0xFFFFFFFF
    m["frame"] = (meta >> 27).astype(np.uint8)
    m["ham"] = ((meta >> 19) & 0xFF).astype(np.uint8)
    m["rh"] = ((meta >> 3) & 0xFFFF).astype(np.uint16)
    m["pos"] = p[3].astype(np.uint32)
    m["dna"] = p[4].astype(np.uint32)
    m["taxid"] = p[5]
    return m


def fetch_compacted(packed_count, bucket_quantum: int = 1 << 15):
    """Transfer only the match prefix (rounded up to a bucket) to host."""
    packed, count = packed_count
    n = int(count)
    total = packed.shape[1]
    k = min(-(-max(n, 1) // bucket_quantum) * bucket_quantum, total)
    arr = packed[:, :k].cpu().numpy()  # one transfer
    return arr[:, :n]
