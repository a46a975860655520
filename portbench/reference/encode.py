"""Six-frame metamer extraction (frozen copy of the port's
ops/encode_np.py; reference src/commons/KmerScanner.h:49-118,
SyncmerScanner.h:9-103, KmerExtractor.cpp:355-386).

A window is emitted iff its 8 codons are N-free; stop codons count.
Positions: forward begin + 3w, reverse seqEnd - 3(w + 8) + 1.  The six
query frames use begin = frame % 3 (forward) and (len % 3 - frame % 3)
mod 3 (reverse) over maxCovered(len) bases.
"""

import numpy as np

from .genetic_code import (CODON2AA, CODON2NUM, KMER_LEN, codes_revcomp,
                           max_covered_length, seq_to_codes)


def _codon_indices(codes, begin, n_codons):
    c = codes[begin:begin + 3 * n_codons].astype(np.uint16)
    c = c.reshape(n_codons, 3)
    return (c[:, 0] << 6) | (c[:, 1] << 3) | c[:, 2]


def _window_u64(vals, bits, k):
    """out[w] = vals[w] << bits*(k-1) | ... | vals[w+k-1]."""
    n = vals.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        out |= vals[j:n - k + 1 + j].astype(np.uint64) \
            << np.uint64(bits * (k - 1 - j))
    return out


def _syncmer_mask(aa, valid, k, s):
    """Open syncmers: the leftmost minimal s-mer of the window sits at
    offset 0 or k - s."""
    n_win = aa.shape[0] - k + 1
    if n_win <= 0:
        return np.zeros(0, bool)
    smer = _window_u64(np.where(valid, aa, 0), 5, s)
    sw = np.lib.stride_tricks.sliding_window_view(smer, k - s + 1)[:n_win]
    argmin = sw.argmin(axis=1)
    return (argmin == 0) | (argmin == k - s)


def scan_frame(codes, begin, used_len, forward, syncmer=False, smer_len=5,
               k=KMER_LEN):
    """(metamers u64, positions u32) of one frame of one sequence."""
    aa_len = used_len // 3
    n_win = aa_len - k + 1
    if n_win <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    seq_end = begin + used_len - 1
    if forward:
        cidx = _codon_indices(codes, begin, aa_len)
    else:
        rc = codes_revcomp(codes)
        cidx = _codon_indices(rc, codes.shape[0] - 1 - seq_end, aa_len)
    aa = CODON2AA[cidx]
    num = CODON2NUM[cidx]
    valid = aa <= 20
    aa_part = _window_u64(np.where(valid, aa, 0), 5, k)
    win_valid = np.lib.stride_tricks.sliding_window_view(valid, k).all(
        axis=1)
    dna_part = _window_u64(np.where(valid, num, 0), 3, k)
    kmers = (aa_part << np.uint64(24)) | dna_part
    w = np.arange(n_win, dtype=np.int64)
    pos = begin + 3 * w if forward else seq_end - 3 * (w + k) + 1
    if syncmer:
        win_valid &= _syncmer_mask(aa, valid, k, smer_len)
    return kmers[win_valid], pos[win_valid].astype(np.uint32)


def extract_query_kmers(seq, syncmer=False, smer_len=5, pos_offset=0):
    """All six frames of one read: (metamers u64, pos u32, frame u8), pos
    shifted by pos_offset (mate 2: maxCovered(len1) + 3)."""
    codes = seq_to_codes(seq)
    L = codes.shape[0]
    used_len = int(max_covered_length(L))
    if used_len < 3 * KMER_LEN:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8))
    ks, ps, fs = [], [], []
    for frame in range(6):
        fwd = frame < 3
        begin = frame % 3 if fwd else (L % 3 - frame % 3) % 3
        kmers, pos = scan_frame(codes, begin, used_len, fwd, syncmer,
                                smer_len)
        ks.append(kmers)
        ps.append(pos + np.uint32(pos_offset))
        fs.append(np.full(kmers.shape[0], frame, dtype=np.uint8))
    return np.concatenate(ks), np.concatenate(ps), np.concatenate(fs)


def extract_target_kmers(seq, syncmer=False, smer_len=5):
    """Six-frame metamers of a whole genome (the index's entries)."""
    return extract_query_kmers(seq, syncmer=syncmer, smer_len=smer_len)[0]
