"""Index probe + candidate hamming filter over the resident wide index.

The DB is a sorted metamer array packed into 512-byte rows
(index/packing.py: 32 entries of (value_lo32, value_hi32, payload_lo,
payload_hi) per row) plus a hash of the unique 40-bit AA parts that maps
each to its run start and run length.  The probe is a point lookup of
every query's AA run, a gather of its first ``cap`` run entries, and a
vectorized per-codon hamming filter (reference compareDna,
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

import torch

from ..index.packing import DNA_BITS, EF_BITS, _HASH_MUL1, _HASH_MUL2
from .genetic_code import HAMMING_TABLE, KMER_LEN

_M32 = 0xFFFFFFFF


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


def match_kmers_quad(q_kmers, q_frames, q_valid, db_quad, cap: int,
                     kmer_format: int, hash_table, hash_log2_rows: int,
                     hash_chain: int, db_m: int = None):
    """Probe the wide index ([R, 128] int32 rows) — cap-MAJOR layout.

    q_kmers int64 [N] metamer bits, q_frames int32 [N], q_valid bool [N].
    Returns a dict of [cap, N] tensors: sel (bool), hamming (int32 sum),
    rh (int32, 16-bit packed per-codon), taxid (= the entry's
    euler-first coordinate), species (species id with the euk flag in
    bit 30), dna_enc (target 24-bit DNA part), plus overflow (int32
    scalar: valid queries whose run exceeds cap).
    """
    if db_quad.shape[1] != 128 or hash_table is None:
        raise NotImplementedError(
            "only the wide-row hash probe is ported (ROADMAP.md, Queue 1 "
            "item 3)")
    M = db_m if db_m is not None else db_quad.shape[0] * 32
    q_aa = (q_kmers >> DNA_BITS) & ((1 << 40) - 1)
    lo, rlen = _hash_search(q_aa, hash_table, hash_log2_rows, hash_chain, M)

    # the run length from the hash tells overflow, so the window is
    # exactly cap entries
    win = cap
    offs = torch.arange(win, device=lo.device)[:, None]
    pos = lo[None, :] + offs
    t_quad = _gather_window_wide(db_quad, lo, win)
    v_lo = t_quad[..., 0]
    v_hi = t_quad[..., 1]
    # AA equality on the split halves: high 32 AA bits live in v_hi,
    # the low 8 in v_lo's top byte
    q_hi = _i32_bits(q_aa >> 8)
    q_low8 = q_aa & 0xFF
    cmask = (v_hi == q_hi[None, :]) \
        & (((v_lo >> 24) & 0xFF).to(torch.int64) == q_low8[None, :]) \
        & (pos < M) & q_valid[None, :]
    cmask = cmask & (offs < rlen[None, :])
    overflow = (q_valid & (rlen > cap)).sum().to(torch.int32)

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
