"""Batched 6-frame metamer extraction in torch.

A batch of reads arrives as a padded uint8 ASCII tensor ``[B, Lmax]``
plus lengths; the whole extraction is table lookups, shifts and masks
over ``[B, W]`` lanes — no per-base control flow.  Windows that touch an
N (or fall beyond a read's usable length) are masked instead of
skipped, the vectorized equivalent of the reference scanner's
restart-after-N loop (reference src/commons/KmerScanner.h:82-117; the
host oracle is ops/encode_np.py).

Output layout: ``[B, 6, W]`` metamer values + positions + validity mask,
where ``W = Lmax//3 - 7`` window slots per frame.  Metamers are int64
holding the u64 bits (the AA part reaches bit 63); every right shift of
one is followed by a mask, so it acts as a logical shift.
"""

import numpy as np
import torch

from .genetic_code import AANUM, KMER_LEN

_DNA_MASK = (1 << 24) - 1


def _codon_tables():
    """(fwd, rc) 64-entry AANUM tables over 2-bit base codes b0b1b2:
    fwd[p] = AANUM of the codon, rc[p] = AANUM of its reverse complement,
    so both strands read the same packed-codon array."""
    fwd = np.empty(64, dtype=np.int64)
    rc = np.empty(64, dtype=np.int64)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                p = (a << 4) | (b << 2) | c
                fwd[p] = AANUM[(a << 6) | (b << 3) | c]
                rc[p] = AANUM[((c ^ 2) << 6) | ((b ^ 2) << 3) | (a ^ 2)]
    return fwd, rc


_TBL_FWD, _TBL_RC = _codon_tables()


def max_windows(l_max: int, k: int = KMER_LEN) -> int:
    """Window slots per frame for reads padded to l_max."""
    return max(l_max // 3 - k + 1, 0)


def _used_len(lengths):
    """maxCoveredLength, branch-free (reference LocalUtil.h:50-59)."""
    rem = lengths % 3
    sub = torch.where(rem == 2, 2, torch.where(rem == 1, 4, 3))
    return lengths - sub


def right_align(arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host-side right-aligned copy of a padded read batch.

    ra[b, i] = arr[b, i - (Lmax - len_b)], 'N' left-fill.  The reverse
    frames read it with fixed strided slices instead of a per-read
    gather.
    """
    B, Lmax = arr.shape
    src = np.arange(Lmax, dtype=np.int64)[None, :] - (Lmax - lens)[:, None]
    ra = arr[np.arange(B)[:, None], np.clip(src, 0, Lmax - 1)]
    ra[src < 0] = ord("N")
    return ra


def _codon_values(reads, table):
    """AANUM value (0..255, 255 = invalid) of the codon starting at every
    base position of `reads` [B, L] -> [B, L-2] int64."""
    v = reads.to(torch.int64) | 0x20
    okb = (v == 97) | (v == 99) | (v == 103) | (v == 116)      # acgt
    c2 = ((v & 14) >> 1) & 3                       # 2-bit code (A0 C1 T2 G3)
    ok3 = okb[:, :-2] & okb[:, 1:-1] & okb[:, 2:]
    p6 = (c2[:, :-2] << 4) | (c2[:, 1:-1] << 2) | c2[:, 2:]
    return torch.where(ok3, table[p6], 255)


def extract_batch(reads, lengths, syncmer: bool = False, smer_len: int = 5,
                  k: int = KMER_LEN, aa_only: bool = False,
                  kmer_format: int = 2, reads_ra=None):
    """Extract metamers for a batch of reads.

    Args:
      reads: uint8 [B, Lmax] ASCII bases (padding value irrelevant).
      lengths: int32 [B] true read lengths.
      syncmer: apply open-syncmer selection on the AA part.
      smer_len: s-mer length for syncmer selection.
      k: amino acids per k-mer (8 metamer, 12 dna2aa).
      aa_only: emit AA-only k-mers (no 24-bit DNA part) — the
        KmerScanner_dna2aa family (reference KmerScanner.h:185-261); at
        k=12 a k-mer is 60 bits, a non-negative int64.
      kmer_format: 2 = current metamer layout; 1 = legacy layout
        (OldMetamerScanner, KmerScanner.h:120-182): codons scanned
        right-to-left, AA part packed base-21, swapped pos formulas.
      reads_ra: optional right-aligned copy of `reads` (right_align);
        built here when absent.

    Returns:
      kmers  int64 [B, 6, W] metamer bits (AA-only k-mers with aa_only) (garbage where invalid),
      pos    int32 [B, 6, W] query coordinates (reference formulas),
      valid  bool  [B, 6, W].
    """
    dev = reads.device
    B, Lmax = reads.shape
    W = max_windows(Lmax, k)
    aa_max = W + k - 1  # codons needed per frame
    lengths = lengths.to(torch.int64)
    tbl_f = torch.as_tensor(_TBL_FWD, device=dev)
    tbl_rc = torch.as_tensor(_TBL_RC, device=dev)

    an_f = _codon_values(reads, tbl_f)
    if reads_ra is None:
        colid = torch.arange(Lmax, device=dev)[None, :]
        src = colid - (Lmax - lengths)[:, None]
        ra = torch.gather(reads, 1, src.clamp(0, Lmax - 1))
        reads_ra = torch.where(src >= 0, ra, ord("N")).to(torch.uint8)
    # rc-direct value at pos j = AANUM of the revcomp codon; reversing
    # puts it in rc-index order, and the right-alignment makes rc index
    # 0 = the read's last codon
    an_rc = _codon_values(reads_ra, tbl_rc).flip(1)

    pad = 3 * aa_max + 2 - (Lmax - 2)             # strided slices need aa_max cols
    if pad > 0:
        fill = torch.full((B, pad), 255, dtype=torch.int64, device=dev)
        an_f = torch.cat([an_f, fill], 1)
        an_rc = torch.cat([an_rc, fill], 1)

    used = _used_len(lengths)                     # [B]
    aa_len = torch.div(used, 3, rounding_mode="floor")
    n_win = aa_len - (k - 1)                      # [B] valid windows per frame
    j = torch.arange(aa_max, device=dev)          # codon index within frame
    widx = torch.arange(W, device=dev)

    def frame_codons(frame):
        if frame < 3:
            begin = torch.full_like(lengths, frame % 3)
            an = an_f[:, frame::3][:, :aa_max]
        else:
            begin = (lengths % 3 - frame % 3) % 3
            # with right-aligned rc the scan start is a pure function of
            # length%3: start = sub(rem) - begin(rem), sub per
            # maxCoveredLength (LocalUtil.h:50-59)
            rem = lengths % 3
            sub = {0: 3, 1: 4, 2: 2}
            s_of = [sub[r] - (r - frame % 3) % 3 for r in (0, 1, 2)]
            sl = [an_rc[:, s::3][:, :aa_max] for s in s_of]
            an = torch.where(rem[:, None] == 0, sl[0],
                             torch.where(rem[:, None] == 1, sl[1], sl[2]))
        aa = an >> 3
        num = an & 7
        cvalid = (aa <= 20) & (j[None, :] < aa_len[:, None])
        return aa, num, cvalid, begin

    def pack_windows(vals, bits):
        out = torch.zeros((B, W), dtype=torch.int64, device=dev)
        for t in range(k):
            out = out | (vals[:, t:t + W] << (bits * (k - 1 - t)))
        return out

    def pack_windows_base21(vals):
        out = torch.zeros((B, W), dtype=torch.int64, device=dev)
        for t in range(k):
            out = out * 21 + vals[:, t:t + W]
        return out

    kmers_all, pos_all, valid_all = [], [], []
    for frame in range(6):
        aa, num, cvalid, begin = frame_codons(frame)
        if kmer_format == 1:
            # legacy scan order = reversed codon axis
            aa, num, cvalid = aa.flip(1), num.flip(1), cvalid.flip(1)
        aa_m = torch.where(cvalid, aa, 0)
        if kmer_format == 1:
            aa_part = pack_windows_base21(aa_m)
        else:
            aa_part = pack_windows(aa_m, 5)
        if aa_only:
            kmers = aa_part
        else:
            num_m = torch.where(cvalid, num, 0)
            dna_part = pack_windows(num_m, 3)
            kmers = (aa_part << 24) | (dna_part & _DNA_MASK)

        # window validity: all k codons valid AND window in range
        wv = torch.ones((B, W), dtype=torch.bool, device=dev)
        for t in range(k):
            wv = wv & cvalid[:, t:t + W]
        if kmer_format == 1:
            scan_pos = widx[None, :] - (aa_max - aa_len[:, None])
            wv = wv & (scan_pos >= 0) & (scan_pos < n_win[:, None])
        else:
            wv = wv & (widx[None, :] < n_win[:, None])
        if syncmer and kmer_format != 1:
            wv = wv & _syncmer_mask_batch(aa_m, W, k, smer_len)

        seq_end = begin + used - 1
        if kmer_format == 1:
            scan_pos = widx[None, :] - (aa_max - aa_len[:, None])
            if frame < 3:
                pos = seq_end[:, None] - 3 * (scan_pos + k) + 1
            else:
                pos = begin[:, None] + 3 * scan_pos
        else:
            if frame < 3:
                pos = begin[:, None] + 3 * widx[None, :]
            else:
                pos = seq_end[:, None] - 3 * (widx[None, :] + k) + 1
        kmers_all.append(kmers)
        pos_all.append(pos.to(torch.int32))
        valid_all.append(wv)
    return (torch.stack(kmers_all, 1), torch.stack(pos_all, 1),
            torch.stack(valid_all, 1))


def _syncmer_mask_batch(aa_m, W, k, s):
    """Open-syncmer anchor test per window, batched.

    Keep window w iff the leftmost-minimal s-mer among offsets 0..k-s sits
    at offset 0 or k-s (reference SyncmerScanner.h:70-90).
    """
    B = aa_m.shape[0]
    n_sm_per_win = k - s + 1
    n_smer = W + n_sm_per_win - 1
    sm = torch.zeros((B, n_smer), dtype=torch.int64, device=aa_m.device)
    for t in range(s):
        sm = sm | (aa_m[:, t:t + n_smer] << (5 * (s - 1 - t)))
    # leftmost argmin over the window's s-mers (s-mers are < 2^35, so
    # 2^62 is above every one of them)
    best = torch.full((B, W), 1 << 62, dtype=torch.int64, device=aa_m.device)
    arg = torch.zeros((B, W), dtype=torch.int64, device=aa_m.device)
    for o in range(n_sm_per_win):
        cand = sm[:, o:o + W]
        better = cand < best
        best = torch.where(better, cand, best)
        arg = torch.where(better, o, arg)
    return (arg == 0) | (arg == k - s)


def compact_windows(kmers, pos, valid, w_c: int):
    """Compact valid windows to the front of the W axis: [B,F,W] -> [B,F,w_c].

    Order is preserved, so the path DP can chain compacted slots using
    real position gaps (dyn_gap).  Empty slots hold 0.

    Returns (kmers_c, pos_c, valid_c, overflow) where overflow counts
    valid windows dropped because a row had more than w_c — the caller
    re-runs with a wider w_c.
    """
    B, F, W = valid.shape
    rank = torch.cumsum(valid.to(torch.int32), -1) - 1
    cnt = rank[..., -1] + 1 if W else torch.zeros((B, F), dtype=torch.int32,
                                                   device=valid.device)
    overflow = torch.clamp(cnt - w_c, min=0).sum().to(torch.int32)
    # each kept window has a unique destination slot; the rest land in
    # the extra slot w_c, which is cut off
    dest = torch.where(valid & (rank < w_c), rank, w_c).to(torch.int64)

    def take(a):
        out = torch.zeros((B, F, w_c + 1), dtype=a.dtype, device=a.device)
        out.scatter_(2, dest, torch.where(dest < w_c, a, 0))
        return out[..., :w_c]

    slots = torch.arange(w_c, device=valid.device)
    vc = slots[None, None, :] < cnt[..., None]
    return take(kmers), take(pos), vc, overflow


def flatten_batch(kmers, pos, valid, seq_ids):
    """[B,6,W] tensors -> flat per-kmer arrays with frame/read annotation.

    seq_ids: int32 [B] 1-based read ids (0 is the reference's blank
    sentinel, QueryKmerInfo at src/commons/Kmer.h:11-16).
    Returns flat (kmers, pos, frame, seq_id, valid) each [B*6*W].
    """
    B, F, W = kmers.shape
    frame = torch.arange(F, dtype=torch.int32,
                         device=kmers.device)[None, :, None].expand(B, F, W)
    sid = seq_ids.to(torch.int32)[:, None, None].expand(B, F, W)
    flat = lambda x: x.reshape(B * F * W)
    return flat(kmers), flat(pos), flat(frame), flat(sid), flat(valid)
