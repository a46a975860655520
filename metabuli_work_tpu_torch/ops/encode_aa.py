"""Protein (aa2aa) k-mer extraction — UniRef pipeline.

Reference: KmerScanner_aa2aa / SyncmerScanner_aa2aa
(src/commons/KmerScanner.h:264-350, SyncmerScanner.h:105-190): direct
5-bit packing of amino-acid k-mers from protein sequences (no frames).
Residue codes: the 20 standard AAs 0..19, B=20 Z=21 U=22 O=23 count as
valid; stop/'X'/gap characters (>23) restart the window.
"""

import numpy as np

_AA_CODE = np.full(256, 27, dtype=np.uint8)
for i, ch in enumerate("ARNDCQEGHILKMFPSTWYV"):
    _AA_CODE[ord(ch)] = i
    _AA_CODE[ord(ch.lower())] = i
_AA_CODE[ord("B")] = 20
_AA_CODE[ord("Z")] = 21
_AA_CODE[ord("U")] = 22
_AA_CODE[ord("O")] = 23
_AA_CODE[ord("*")] = 24
for ch in "-.?":
    _AA_CODE[ord(ch)] = 25
_AA_CODE[ord("X")] = 26


def extract_protein_kmers(seq: str, k: int = 12, syncmer: bool = False,
                          smer_len: int = 5):
    """(kmers u64, pos u32) for one protein sequence."""
    arr = np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8)
    codes = _AA_CODE[arr]
    n = len(codes)
    if n < k:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    valid = codes <= 23

    vals = np.where(valid, codes, 0).astype(np.uint64)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        out |= vals[j: n - k + 1 + j] << np.uint64(5 * (k - 1 - j))
    win_valid = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)

    if syncmer:
        s = smer_len
        smer = np.zeros(n - s + 1, dtype=np.uint64)
        for j in range(s):
            smer |= vals[j: n - s + 1 + j] << np.uint64(5 * (s - 1 - j))
        sw = np.lib.stride_tricks.sliding_window_view(smer, k - s + 1)[: n - k + 1]
        argmin = sw.argmin(axis=1)
        win_valid &= (argmin == 0) | (argmin == k - s)

    pos = np.arange(n - k + 1, dtype=np.uint32)
    return out[win_valid], pos[win_valid]
