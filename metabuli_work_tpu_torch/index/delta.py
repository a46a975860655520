"""15-bit-chunk delta codec for reference-format `diffIdx` interop.

The reference stores the sorted metamer stream as per-entry deltas split
big-endian-first into 15-bit uint16 chunks; the final chunk of each delta
has bit 15 set (reference encoder IndexCreator.cpp:868-886, decoder
KmerMatcher.h:282-329).  These vectorized numpy routines read/write that
exact on-disk format so databases can be cross-validated k-mer-for-k-mer
and old DBs converted to the native sharded layout.  The 96-bit
(metamer, id) codec of the newer deltaIdx.mtbl layout is here too.
"""

import numpy as np

END_FLAG = np.uint16(0x8000)
CHUNK_MASK = np.uint64(0x7FFF)


def encode_deltas(values: np.ndarray) -> np.ndarray:
    """Sorted uint64 values -> uint16 chunk stream (delta vs previous, first
    delta taken against 0)."""
    values = np.asarray(values, dtype=np.uint64)
    if len(values) == 0:
        return np.zeros(0, dtype=np.uint16)
    diffs = np.empty_like(values)
    diffs[0] = values[0]
    np.subtract(values[1:], values[:-1], out=diffs[1:])

    # number of 15-bit chunks needed per delta (>=1), via repeated shifts
    nchunks = np.ones(len(diffs), dtype=np.int64)
    tmp = diffs >> np.uint64(15)
    while tmp.any():
        nchunks += (tmp > 0).astype(np.int64)
        tmp = tmp >> np.uint64(15)

    total = int(nchunks.sum())
    out = np.zeros(total, dtype=np.uint16)
    ends = np.cumsum(nchunks) - 1  # index of the end-flagged chunk per delta
    # fill chunks: for chunk j (0 = most significant of that delta),
    # value = (diff >> 15*(nchunks-1-j)) & 0x7FFF
    max_c = int(nchunks.max())
    for j in range(max_c):
        has = nchunks > j
        pos = ends[has] - (nchunks[has] - 1 - j)
        shift = (nchunks[has] - 1 - j).astype(np.uint64) * np.uint64(15)
        out[pos] = ((diffs[has] >> shift) & CHUNK_MASK).astype(np.uint16)
    out[ends] |= END_FLAG
    return out


def decode_deltas(chunks: np.ndarray) -> np.ndarray:
    """uint16 chunk stream -> uint64 absolute values."""
    chunks = np.asarray(chunks, dtype=np.uint16)
    if len(chunks) == 0:
        return np.zeros(0, dtype=np.uint64)
    is_end = (chunks & END_FLAG) != 0
    n = int(is_end.sum())
    ends = np.nonzero(is_end)[0]
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    nchunks = ends - starts + 1
    payload = (chunks & np.uint16(0x7FFF)).astype(np.uint64)
    diffs = np.zeros(n, dtype=np.uint64)
    max_c = int(nchunks.max())
    for j in range(max_c):
        has = nchunks > j
        pos = starts[has] + j
        shift = (nchunks[has] - 1 - j).astype(np.uint64) * np.uint64(15)
        diffs[has] |= payload[pos] << shift
    return np.cumsum(diffs, dtype=np.uint64)


def decode_metamer_deltas(chunks: np.ndarray):
    """Decode the `.mtbl` 96-bit (metamer, id) delta stream.

    Reference: Metamer::substract/add (src/commons/Kmer.h:127-153) +
    matchMetamers (KmerMatcher.cpp:780-812): each entry is a 96-bit word
    (metamer_delta << 30 | id_delta) in 15-bit chunks; on accumulation a
    carry out of the low 30 bits increments the metamer.  Because each
    step truncates the id to 30 bits, the chain telescopes: with the
    cumulative low-part sum S_i, id_i = S_i & (2^30-1) and
    metamer_i = cumsum(high parts) + (S_i >> 30).

    Returns (metamers uint64 [n], ids uint32 [n]).
    """
    dhi66, dlo30 = _split_deltas_96(chunks)
    if len(dhi66) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    s = np.cumsum(dlo30, dtype=np.uint64)
    ids = (s & np.uint64((1 << 30) - 1)).astype(np.uint32)
    metamers = np.cumsum(dhi66, dtype=np.uint64) + (s >> np.uint64(30))
    return metamers, ids


def _split_deltas_96(chunks: np.ndarray):
    """Per-entry (high-66-bit, low-30-bit) delta parts of a 96-bit chunk
    stream — shared by the one-shot decoder above and the windowed
    import (format._decode_mtbl_window)."""
    chunks = np.asarray(chunks, dtype=np.uint16)
    if len(chunks) == 0:
        z = np.zeros(0, np.uint64)
        return z, z
    is_end = (chunks & END_FLAG) != 0
    ends = np.nonzero(is_end)[0]
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    nchunks = ends - starts + 1
    payload = (chunks & np.uint16(0x7FFF)).astype(np.uint64)

    n = len(ends)
    # 128-bit accumulate as (hi, lo) u64 pairs
    d_lo = np.zeros(n, dtype=np.uint64)
    d_hi = np.zeros(n, dtype=np.uint64)
    for j in range(int(nchunks.max())):
        has = nchunks > j
        p = payload[starts[has] + j]
        # (hi, lo) = (hi, lo) << 15 | p
        d_hi[has] = (d_hi[has] << np.uint64(15)) | (d_lo[has] >> np.uint64(49))
        d_lo[has] = (d_lo[has] << np.uint64(15)) | p

    mask30 = np.uint64((1 << 30) - 1)
    dlo30 = d_lo & mask30
    dhi66 = (d_hi << np.uint64(34)) | (d_lo >> np.uint64(30))
    return dhi66, dlo30


def encode_metamer_deltas(metamers: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Inverse of decode_metamer_deltas (for tests / DB export): each
    entry's 96-bit word (metamer << 30 | id) minus the previous entry's,
    in 15-bit chunks, most significant first.  Vectorised over the
    entries: the 128-bit words and their differences are (hi, lo) u64
    pairs with the borrow carried from lo to hi.  Entries must ascend
    by (metamer, id)."""
    m = np.asarray(metamers, dtype=np.uint64)
    i = np.asarray(ids, dtype=np.uint64)
    if len(m) == 0:
        return np.zeros(0, dtype=np.uint16)
    lo = (m << np.uint64(30)) | i
    hi = m >> np.uint64(34)
    prev_lo = np.concatenate([np.zeros(1, np.uint64), lo[:-1]])
    prev_hi = np.concatenate([np.zeros(1, np.uint64), hi[:-1]])
    borrow = lo < prev_lo
    if np.any((hi < prev_hi) | ((hi == prev_hi) & borrow)):
        raise ValueError("entries do not ascend by (metamer, id)")
    d_lo = lo - prev_lo
    d_hi = hi - prev_hi - borrow.astype(np.uint64)

    # chunks per delta (>= 1): shift the 128-bit difference by 15 until 0
    nchunks = np.ones(len(m), dtype=np.int64)
    t_hi, t_lo = d_hi, d_lo
    while True:
        t_lo = (t_lo >> np.uint64(15)) | (t_hi << np.uint64(49))
        t_hi = t_hi >> np.uint64(15)
        more = (t_hi | t_lo) != 0
        if not more.any():
            break
        nchunks += more
    ends = np.cumsum(nchunks) - 1   # the end-flagged (least significant) chunk
    out = np.zeros(int(ends[-1]) + 1, dtype=np.uint16)
    # chunk k from the least significant end sits k places before the end
    for k in range(int(nchunks.max())):
        has = nchunks > k
        out[ends[has] - k] = (d_lo[has] & CHUNK_MASK).astype(np.uint16)
        d_lo = (d_lo >> np.uint64(15)) | (d_hi << np.uint64(49))
        d_hi = d_hi >> np.uint64(15)
    out[ends] |= END_FLAG
    return out


def count_entries(chunks: np.ndarray) -> int:
    """Number of encoded values (= end-flagged chunks); used by validatedb
    (reference src/util/validateDatabase.cpp:103-130)."""
    chunks = np.asarray(chunks, dtype=np.uint16)
    return int(((chunks & END_FLAG) != 0).sum())
