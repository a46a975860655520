"""Vectorized (numpy) metamer extraction — host oracle and DB-build path.

Reproduces the reference scanner semantics exactly
(reference: src/commons/KmerScanner.h:49-118, SyncmerScanner.h:9-103,
KmerExtractor.cpp:355-386) but as array ops over whole sequences instead
of per-base scalar loops:

* a window is emitted iff all 8 of its codons are N-free (the reference's
  restart-after-N control flow reduces to exactly this predicate),
* stop codons (AA id 20) are included, only N restarts,
* positions follow the reference formulas:
  forward  pos = begin + 3*w
  reverse  pos = seqEnd - 3*(w + 8) + 1     (seqEnd = begin + usedLen - 1)
* the 6 query frames use begin = frame%3 (forward) and
  begin = (len%3 - frame%3) mod 3 (reverse) over usedLen = maxCovered(len).

The same machinery backs the batched torch encoder (ops/encode_torch.py) — this
module is the readable ground truth that tests pin down.
"""

from dataclasses import dataclass

import numpy as np

from .genetic_code import (
    CODON2AA,
    CODON2NUM,
    KMER_LEN,
    codes_revcomp,
    max_covered_length,
    seq_to_codes,
)

_POW2 = None


def codon_indices(codes: np.ndarray, begin: int, n_codons: int) -> np.ndarray:
    """9-bit codon table indices for codons starting at begin, begin+3, ..."""
    c = codes[begin : begin + 3 * n_codons].astype(np.uint16)
    c = c.reshape(n_codons, 3)
    return (c[:, 0] << 6) | (c[:, 1] << 3) | c[:, 2]


def _window_u64(vals: np.ndarray, bits: int, k: int) -> np.ndarray:
    """Pack k consecutive `bits`-bit lanes into one u64 per window position.

    vals: (n,) uint64 small ints; returns (n-k+1,) uint64 where out[w] =
    vals[w]<<bits*(k-1) | ... | vals[w+k-1].
    """
    n = vals.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        out |= vals[j : n - k + 1 + j].astype(np.uint64) << np.uint64(bits * (k - 1 - j))
    return out


@dataclass
class FrameKmers:
    """Metamers of one reading frame of one sequence."""

    kmers: np.ndarray  # (n,) uint64 metamer values
    pos: np.ndarray    # (n,) uint32 query/sequence coordinates


def scan_frame(
    codes: np.ndarray,
    begin: int,
    used_len: int,
    forward: bool,
    syncmer: bool = False,
    smer_len: int = 5,
    k: int = KMER_LEN,
    aa_only: bool = False,
) -> FrameKmers:
    """Extract metamers of a single frame from 3-bit nucleotide codes.

    `codes` is the *forward-strand* code array; for reverse frames the
    reverse-complement is derived internally so position bookkeeping stays
    in forward coordinates (reference KmerScanner.h:94-97,110-114).

    aa_only=True yields amino-acid-only k-mers (reference
    KmerScanner_dna2aa, KmerScanner.h:185-261; k=12 for the read-group
    and common-k-mer pipelines).
    """
    aa_len = used_len // 3
    n_win = aa_len - k + 1
    if n_win <= 0:
        return FrameKmers(np.zeros(0, np.uint64), np.zeros(0, np.uint32))

    seq_end = begin + used_len - 1
    if forward:
        cidx = codon_indices(codes, begin, aa_len)
    else:
        # Reverse scanner reads complemented triplets from seq_end downward;
        # equivalent to forward codons of revcomp(codes) starting at the
        # mirrored offset.
        rc = codes_revcomp(codes)
        L = codes.shape[0]
        rc_begin = L - 1 - seq_end
        cidx = codon_indices(rc, rc_begin, aa_len)

    aa = CODON2AA[cidx]            # (aa_len,) uint8; 31 = invalid (N)
    num = CODON2NUM[cidx]
    valid = aa <= 20

    aa_part = _window_u64(np.where(valid, aa, 0), 5, k)
    win_valid = (
        np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
        if aa_len >= k
        else np.zeros(0, bool)
    )

    if aa_only:
        kmers = aa_part
    else:
        dna_part = _window_u64(np.where(valid, num, 0), 3, k)
        kmers = (aa_part << np.uint64(24)) | dna_part
    w = np.arange(n_win, dtype=np.int64)
    if forward:
        pos = begin + 3 * w
    else:
        pos = seq_end - 3 * (w + k) + 1

    if syncmer:
        win_valid &= _syncmer_mask(aa, valid, k, smer_len)

    sel = win_valid
    return FrameKmers(kmers[sel], pos[sel].astype(np.uint32))


def _syncmer_mask(aa: np.ndarray, valid: np.ndarray, k: int, s: int) -> np.ndarray:
    """Open-syncmer selection mask over k-AA windows.

    Window w is kept iff the leftmost-minimal s-mer of the window sits at
    offset 0 or k-s (reference SyncmerScanner.h:70-90; the monotone deque
    keeps the earliest position on ties because only strictly-greater
    values are popped).
    """
    aa_len = aa.shape[0]
    n_smer = aa_len - s + 1
    n_win = aa_len - k + 1
    if n_win <= 0:
        return np.zeros(0, bool)
    smer = _window_u64(np.where(valid, aa, 0), 5, s)
    # s-mers inside each window: (n_win, k-s+1)
    sw = np.lib.stride_tricks.sliding_window_view(smer, k - s + 1)[:n_win]
    argmin = sw.argmin(axis=1)  # leftmost min on ties (numpy semantics match)
    return (argmin == 0) | (argmin == k - s)


def extract_query_kmers(
    seq,
    syncmer: bool = False,
    smer_len: int = 5,
    pos_offset: int = 0,
    k: int = KMER_LEN,
    aa_only: bool = False,
):
    """All-6-frame query extraction for one read.

    Returns (kmers u64, pos u32, frame u8) with pos already shifted by
    `pos_offset` (paired-end mate-2 uses queryLength1 + 3, reference
    KmerExtractor.cpp:341-345).
    """
    codes = seq_to_codes(seq)
    L = codes.shape[0]
    used_len = int(max_covered_length(L))
    if used_len < 3 * k:
        z = np.zeros(0, np.uint64)
        return z, np.zeros(0, np.uint32), np.zeros(0, np.uint8)

    all_kmers, all_pos, all_frames = [], [], []
    for frame in range(6):
        fwd = frame < 3
        if fwd:
            begin = frame % 3
        else:
            begin = (L % 3 - frame % 3) % 3
        fk = scan_frame(codes, begin, used_len, fwd, syncmer, smer_len, k=k, aa_only=aa_only)
        all_kmers.append(fk.kmers)
        all_pos.append(fk.pos + np.uint32(pos_offset))
        all_frames.append(np.full(fk.kmers.shape[0], frame, dtype=np.uint8))
    return (
        np.concatenate(all_kmers),
        np.concatenate(all_pos),
        np.concatenate(all_frames),
    )


def extract_target_kmers(seq, syncmer: bool = False, smer_len: int = 5) -> np.ndarray:
    """Six-frame metamer extraction for a reference sequence (DB build).

    Note: the reference builds its DB from Prodigal-predicted extended ORF
    blocks (IndexCreator.cpp:1088-1212); we index all six frames of the
    whole genome — a strict superset that trades DB size for a build path
    with no gene-prediction dependency.  CDS-guided extraction can be added
    on top (same scan_frame machinery over sub-ranges).
    """
    kmers, _, _ = extract_query_kmers(seq, syncmer=syncmer, smer_len=smer_len)
    return kmers
