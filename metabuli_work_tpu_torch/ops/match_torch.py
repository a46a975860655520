"""Index probe + candidate hamming filter over the resident index.

Two probes share the hamming filter:

* match_kmers_quad (the path-DP flow): the sorted metamer array packed
  into 512-byte rows (index/packing.py: 32 entries of (value_lo32,
  value_hi32, payload_lo, payload_hi) per row) plus a hash of the unique
  40-bit AA parts that maps each to its run start and run length.  The
  probe is a point lookup of every query's AA run and a gather of its
  first ``cap`` run entries.  The narrow layouts (64-byte block rows,
  run starts aligned or not, entry-row shards) and the bucket bisection
  in place of the hash are the same probe over other rows.
* match_kmers / match_kmers_cm (the host-match flow): the raw sorted
  arrays (values, taxids, species).  The run start comes from one
  bucket-pair gather plus a short bisection on the low 32 AA bits
  (build_buckets), or from a full searchsorted without the tables; a
  ``cap + 1``'th window row tells overflow.

Both end in a vectorized per-codon hamming filter (reference compareDna,
src/commons/KmerMatcher.cpp:1117-1146).

Equivalence notes:
* the reference memoizes candidate lists across equal AA parts; with
  independent lookups every query slot recomputes the same run bounds,
  so results are identical.
* candidate selection keeps hamming <= min(2*minHamming, 7) among the
  candidates of the same AA run (KmerMatcher.cpp:1136).
* per-codon 2-bit hamming packing follows getHammings/getHammings_reverse
  (KmerMatcher.h:386-416): codon i (from the k-mer's low bits) lands in
  2-bit field i (forward) or 7-i (reverse); values are mod-4 truncations
  of the full per-codon distance.

Index words are u32 bits carried as int32 and metamers u64 bits carried
as int64: every right shift is followed by a mask.
"""

import numpy as np
import torch

from ..index.packing import DNA_BITS, EF_BITS, _HASH_MUL1, _HASH_MUL2
from .genetic_code import HAMMING_TABLE, KMER_LEN

_M32 = 0xFFFFFFFF
_M40 = (1 << 40) - 1


def _i32_bits(x):
    """int64 holding a u32 value -> int32 with the same bits."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _hash_search(q_aa, hash_table, log2_rows: int, chain: int, M: int):
    """Point lookup of run starts: ``chain`` row gathers + compares over
    the row's slots.  Returns (lo [N] int64 — M when absent, run_len [N]
    int64 — 0 when absent)."""
    q_lo = q_aa & _M32
    q_hi = (q_aa >> 32) & _M32
    h = ((((q_lo * int(_HASH_MUL1)) & _M32) ^ ((q_hi * int(_HASH_MUL2)) & _M32))
         >> (32 - log2_rows))
    R = hash_table.shape[0]
    slots = hash_table.shape[1] // 3
    q_lo32 = _i32_bits(q_lo)
    q_tag = _i32_bits(q_hi | 0x100)
    lo = torch.full(q_aa.shape, M, dtype=torch.int64, device=q_aa.device)
    rlen = torch.zeros(q_aa.shape, dtype=torch.int64, device=q_aa.device)
    for c in range(chain):
        row = hash_table[torch.clamp(h + c, max=R - 1)]
        for s in range(slots):
            w1 = row[:, 3 * s + 1]
            hit = (row[:, 3 * s] == q_lo32) & ((w1 & 0x1FF) == q_tag)
            lo = torch.where(hit, row[:, 3 * s + 2].to(torch.int64), lo)
            rlen = torch.where(hit, ((w1 >> 9) & 0x7FFFFF).to(torch.int64),
                               rlen)
    return lo, rlen


def _gather_window_wide(db_w, lo, win: int):
    """[win, N, 4] candidate entries lo .. lo+win-1 from 512-byte rows.

    Entry e lives at row e >> 5, slot e & 31; indices past the padded
    end clamp to the last entry, which (like every padding entry) is an
    all-ones sentinel that never AA-matches a query."""
    ent = db_w.view(-1, 4)
    offs = torch.arange(win, device=lo.device)[:, None]
    idx = torch.clamp(lo[None, :] + offs, max=ent.shape[0] - 1)
    return ent[idx]


def _gather_blocks(db_blk, lo, win: int, aligned: bool):
    """[win, N, 4] candidate entries lo .. lo+win-1 from 64-byte block
    rows ([R, 16]: 4 entries a row).

    aligned (run starts block-aligned by packing.align_runs4): exactly
    ceil(win/4) block gathers from lo >> 2 and no shuffle.  Unaligned:
    (win+6)//4 consecutive blocks, then window entry j is entry
    (lo & 3) + j of the gathered blocks.  Block indices past the end
    clamp to the last block, which (like every pad) holds all-ones
    sentinels that never AA-match a query."""
    R = db_blk.shape[0]
    n = lo.shape[0]
    b0 = lo >> 2
    nblk = (win + 3) // 4 if aligned else (win + 6) // 4
    ks = torch.arange(nblk, device=lo.device)
    ent = db_blk[torch.clamp(b0[:, None] + ks[None, :], max=R - 1)]
    ent = ent.reshape(n, 4 * nblk, 4)
    if aligned:
        return ent[:, :win, :].permute(1, 0, 2)
    j = (lo & 3)[None, :] + torch.arange(win, device=lo.device)[:, None]
    return torch.gather(ent.permute(1, 0, 2), 0,
                        j[:, :, None].expand(win, n, 4))


def match_kmers_quad(q_kmers, q_frames, q_valid, db_quad, cap: int,
                     kmer_format: int, hash_table=None,
                     hash_log2_rows: int = 0, hash_chain: int = 0,
                     db_m: int = None, aligned: bool = False,
                     bucket_lo=None, db_aa_lo=None, bucket_shift: int = 0,
                     bucket_steps: int = 0, lo_override=None):
    """Probe the packed index — cap-MAJOR layout.

    db_quad is one of three int32 layouts (packing.py):
    * [R, 128] 512-byte rows (the default wide layout; needs the hash);
    * [R, 16] 64-byte block rows (the narrow layout; db_m, the entry
      count with any alignment padding, is required; `aligned` when run
      starts sit on block boundaries);
    * [S, 4] entry rows (a narrow shard; db_m defaults to S).
    Run starts come from lo_override, else the AA hash (hash_table: the
    run length comes with the start, so the window is exactly cap
    entries and overflow is known from the lookup), else the bucket
    bisection (bucket_lo, db_aa_lo, bucket_shift, bucket_steps of
    build_buckets: the window keeps a cap+1'th entry, whose AA match
    tells overflow).

    q_kmers int64 [N] metamer bits, q_frames int32 [N], q_valid bool [N].
    Returns a dict of [cap, N] tensors: sel (bool), hamming (int32 sum),
    rh (int32, 16-bit packed per-codon), taxid (= the entry's
    euler-first coordinate), species (species id with the euk flag in
    bit 30), dna_enc (target 24-bit DNA part), plus overflow (int32
    scalar: valid queries whose run exceeds cap).
    """
    width = db_quad.shape[1]
    if width == 128:
        M = db_m if db_m is not None else db_quad.shape[0] * 32
    elif width == 16:
        if db_m is None:
            raise ValueError("a block-row index needs db_m")
        M = db_m
    else:
        M = db_m if db_m is not None else db_quad.shape[0]
    q_aa = (q_kmers >> DNA_BITS) & _M40
    rlen = None
    if lo_override is not None:
        lo = lo_override
    elif hash_table is not None:
        lo, rlen = _hash_search(q_aa, hash_table, hash_log2_rows,
                                hash_chain, M)
    else:
        lo = _bucket_search(q_aa, bucket_lo, db_aa_lo, bucket_shift,
                            bucket_steps, M)

    # with run lengths from the hash the window is exactly cap entries;
    # without them it keeps a cap+1'th entry for the overflow check
    win = cap if rlen is not None else cap + 1
    offs = torch.arange(win, device=lo.device)[:, None]
    pos = lo[None, :] + offs
    if width == 128:
        if rlen is None:
            raise ValueError("the wide layout needs the AA hash")
        t_quad = _gather_window_wide(db_quad, lo, win)
    elif width == 16:
        t_quad = _gather_blocks(db_quad, lo, win, aligned)
    else:
        t_quad = db_quad[torch.clamp(pos, 0, M - 1)]
    v_lo = t_quad[..., 0]
    v_hi = t_quad[..., 1]
    # AA equality on the split halves: high 32 AA bits live in v_hi,
    # the low 8 in v_lo's top byte
    q_hi = _i32_bits(q_aa >> 8)
    q_low8 = q_aa & 0xFF
    cmask = (v_hi == q_hi[None, :]) \
        & (((v_lo >> 24) & 0xFF).to(torch.int64) == q_low8[None, :]) \
        & (pos < M) & q_valid[None, :]
    if rlen is not None:
        cmask = cmask & (offs < rlen[None, :])
        overflow = (q_valid & (rlen > cap)).sum().to(torch.int32)
    else:
        overflow = cmask[cap].sum().to(torch.int32)
        cmask = cmask[:cap]
        t_quad = t_quad[:cap]
        v_lo = v_lo[:cap]

    t_dna = v_lo & ((1 << DNA_BITS) - 1)
    q_dna = (q_kmers & ((1 << DNA_BITS) - 1)).to(torch.int32)[None, :]
    sel, hsum, rh = _hamming_filter(t_dna, q_dna, cmask, q_frames,
                                    kmer_format)

    p_lo = t_quad[..., 2]
    p_hi = t_quad[..., 3]
    ef = p_lo & ((1 << EF_BITS) - 1)
    species = ((p_lo >> EF_BITS) & 0x7F) | (p_hi << 7)
    return {
        "sel": sel,
        "hamming": hsum,
        "rh": rh,
        "taxid": ef,
        "species": species,
        "dna_enc": t_dna,
        "overflow": overflow,
    }


def _hamming_filter(t_dna, q_dna, cmask, q_frames, kmer_format: int):
    """Per-codon hamming + cutoff + rh packing (cap-major)."""
    table = torch.as_tensor(HAMMING_TABLE.astype("int32"),
                            device=t_dna.device)
    hsum = torch.zeros_like(t_dna)
    rh_fwd = torch.zeros_like(t_dna)
    rh_rev = torch.zeros_like(t_dna)
    for i in range(KMER_LEN):
        qi = (q_dna >> (3 * i)) & 7
        ti = (t_dna >> (3 * i)) & 7
        h = table[((qi << 3) | ti).to(torch.int64)]
        h2 = h & 3
        hsum = hsum + h
        rh_fwd = rh_fwd | (h2 << (2 * i))
        rh_rev = rh_rev | (h2 << (2 * (KMER_LEN - 1 - i)))

    hsum_m = torch.where(cmask, hsum, 255)
    min_h = hsum_m.min(0, keepdim=True).values
    cutoff = torch.clamp(min_h * 2, max=7)
    sel = cmask & (hsum <= cutoff)

    fwd_frame = q_frames < 3
    use_fwd = ~(fwd_frame ^ (kmer_format == 2))
    rh = torch.where(use_fwd[None, :], rh_fwd, rh_rev)
    return sel, hsum, rh


def build_buckets(values: np.ndarray, max_bits: int = 24):
    """Host-side bucket table over the AA part of a sorted metamer array.

    Returns (bucket_pair int32 [2^bits, 2], aa_lo uint32 [M], shift,
    steps): bucket b covers AA parts whose top ``40-shift`` bits equal
    b, so a probe narrows to [pair[b,0], pair[b,1]) with ONE row gather
    and finishes with ``steps`` binary-search iterations comparing only
    the low 32 AA bits (valid because bits >= 8).  The reference's
    analogue is the 4096-entry `split` checkpoint table
    (IndexCreator.cpp:811-866).
    """
    aa = (values >> np.uint64(DNA_BITS)).astype(np.uint64)
    m = len(aa)
    bits = int(min(max_bits, max(8, int(np.ceil(np.log2(max(m, 2)))) + 3)))
    shift = 40 - bits
    b = (aa >> np.uint64(shift)).astype(np.int64)
    counts = np.bincount(b, minlength=1 << bits)
    bucket_lo = np.zeros((1 << bits) + 1, dtype=np.int32)
    np.cumsum(counts, out=bucket_lo[1:])
    bucket_pair = np.ascontiguousarray(
        np.stack([bucket_lo[:-1], bucket_lo[1:]], axis=1))
    max_run = int(counts.max()) if m else 0
    steps = max(1, int(np.ceil(np.log2(max_run + 1)))) if max_run else 1
    aa_lo = (aa & np.uint64(_M32)).astype(np.uint32)
    return bucket_pair, aa_lo, shift, steps


def _bucket_search(q_aa, bucket_lo, db_aa_lo, bucket_shift: int,
                   bucket_steps: int, M: int):
    """Left-edge binary search: ONE bucket-pair row gather + low-32-bit
    bisection.  q_aa int64 (40-bit, non-negative); bucket_lo int32
    [2^bits, 2] (lo, hi) pairs; db_aa_lo int32 holding u32 bits, widened
    to int64 and masked before every compare (an unsigned compare)."""
    pair = bucket_lo[q_aa >> bucket_shift].to(torch.int64)
    lo, hi = pair[:, 0], pair[:, 1]
    q_lo32 = q_aa & _M32
    for _ in range(bucket_steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = db_aa_lo[torch.clamp(mid, 0, M - 1)].to(torch.int64) & _M32
        go = active & (v < q_lo32)
        hi = torch.where(active & ~go, mid, hi)
        lo = torch.where(go, mid + 1, lo)
    return lo


def match_kmers_cm(q_kmers, q_frames, q_valid, db_values, db_taxids,
                   db_species, cap: int = 64, kmer_format: int = 2,
                   bucket_lo=None, db_aa_lo=None, bucket_shift: int = 0,
                   bucket_steps: int = 0):
    """Probe the sorted DB arrays with query metamers — cap-MAJOR layout.

    db_values int64 [M] (u64 metamer bits, sorted as unsigned),
    db_taxids / db_species int32 [M].  One search finds each query's run
    start; run membership is an equality test on the gathered AA parts
    (the reference's two-pointer merge makes the same comparison,
    KmerMatcher.cpp:251-466), and overflow is detected by probing one
    extra slot past the cap.

    Returns a dict of [cap, N] tensors: sel (bool), hamming (int32 sum),
    rh (int32, 16-bit packed per-codon), taxid, species, dna_enc (int32,
    target 24-bit DNA part), plus overflow (int32 scalar: queries whose
    run exceeded cap).
    """
    dna_mask = (1 << DNA_BITS) - 1
    M = db_values.shape[0]
    q_aa = (q_kmers >> DNA_BITS) & _M40

    if bucket_lo is not None:
        lo = _bucket_search(q_aa, bucket_lo, db_aa_lo, bucket_shift,
                            bucket_steps, M)
    else:
        db_aa = (db_values >> DNA_BITS) & _M40
        lo = torch.searchsorted(db_aa, q_aa, side="left")

    # one extra row past the cap: a query whose run still matches there
    # overflowed (the pipeline retries with a doubled cap while any
    # query overflows)
    offs = torch.arange(cap + 1, device=lo.device)[:, None]
    pos = lo[None, :] + offs
    idx = torch.clamp(pos, 0, M - 1)
    t_vals = db_values[idx]
    cmask = (((t_vals >> DNA_BITS) & _M40) == q_aa[None, :]) \
        & (pos < M) & q_valid[None, :]
    overflow = cmask[cap].sum().to(torch.int32)
    cmask = cmask[:cap]
    idx = idx[:cap]

    t_dna = (t_vals[:cap] & dna_mask).to(torch.int32)
    q_dna = (q_kmers & dna_mask).to(torch.int32)[None, :]
    sel, hsum, rh = _hamming_filter(t_dna, q_dna, cmask, q_frames,
                                    kmer_format)
    return {
        "sel": sel,
        "hamming": hsum,
        "rh": rh,
        "taxid": db_taxids[idx],
        "species": db_species[idx],
        "dna_enc": t_dna,
        "overflow": overflow,
    }


def match_kmers(q_kmers, q_frames, q_valid, db_values, db_taxids, db_species,
                cap: int = 64, kmer_format: int = 2, bucket_lo=None,
                db_aa_lo=None, bucket_shift: int = 0, bucket_steps: int = 0):
    """match_kmers_cm with the query-major [N, cap] public layout."""
    out = match_kmers_cm(q_kmers, q_frames, q_valid, db_values, db_taxids,
                         db_species, cap=cap, kmer_format=kmer_format,
                         bucket_lo=bucket_lo, db_aa_lo=db_aa_lo,
                         bucket_shift=bucket_shift, bucket_steps=bucket_steps)
    return {k: (v if v.ndim == 0 else v.T) for k, v in out.items()}
