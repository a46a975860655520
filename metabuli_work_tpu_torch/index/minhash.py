"""Min-hash strandness check (DB-build utility).

Counterpart of the reference's SeqIterator::getMinHashList /
compareMinHashList (src/commons/SeqIterator.cpp:65-113): a bottom-3000
sketch of 64-bit hashes over all 24-mers of a sequence, compared by
counting shared hash values between two sketches; two sequences are
"similar" (same strand) when the shared count exceeds
``0.5 * |sketch1| * (len2/len1)``.

The reference uses this during DB builds (IndexCreator.cpp:1158-1212)
to detect contigs stored reverse-complemented relative to their
species' Prodigal training sequence, re-predicting genes on the reverse
complement when the forward comparison fails.  In this framework the
check is advisory: the ORF predictor (index/orf.py) scans BOTH strands
of every contig, so gene blocks are strand-complete either way — the
builder exposes the check for diagnostics and for users porting
reference build recipes.

Hash note: the reference hashes raw 24-char windows with XXH64.  Hash
values never leave the build decision (nothing on disk or in the index
depends on them), so this implementation uses a vectorized
splitmix64-style mix over byte-packed windows instead of a bit-exact
XXH64 — same sketch semantics, no scalar per-window loop.
"""

import numpy as np

KMER_LEN = 24      # reference SeqIterator.cpp:90
SKETCH_SIZE = 3000  # reference SeqIterator.cpp:94 (maxLength)

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    # uint64 wraparound is the point of the mix; silence numpy's
    # overflow RuntimeWarning explicitly instead of leaking it to callers
    with np.errstate(over="ignore"):
        x = x.copy()
        x ^= x >> np.uint64(33)
        x *= _M1
        x ^= x >> np.uint64(33)
        x *= _M2
        x ^= x >> np.uint64(33)
    return x


def minhash_sketch(seq: str, k: int = KMER_LEN,
                   sketch: int = SKETCH_SIZE) -> np.ndarray:
    """Bottom-``sketch`` 64-bit hashes over all k-mers of ``seq``.

    Returns a sorted ascending uint64 array of at most ``sketch``
    distinct window hashes (empty when len(seq) < k).  Windows hash the
    raw characters, so N's and case differences matter — same contract
    as the reference's strncpy+XXH64 windows.
    """
    b = np.frombuffer(seq.encode(), dtype=np.uint8)
    n = len(b) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    # rolling pack: three 8-byte words per window, mixed and combined
    w = np.lib.stride_tricks.sliding_window_view(b, k)[:n]
    h = np.zeros(n, dtype=np.uint64)
    for j in range(0, k, 8):
        word = w[:, j:j + 8].astype(np.uint64)
        packed = np.zeros(n, dtype=np.uint64)
        for byte in range(word.shape[1]):
            packed |= word[:, byte] << np.uint64(8 * byte)
        with np.errstate(over="ignore"):   # uint64 wraparound intended
            h = _mix64(h + packed + _GOLDEN * np.uint64(j // 8 + 1))
    h = np.unique(h)
    return h[:sketch]


def minhash_similar(sk1: np.ndarray, sk2: np.ndarray,
                    len1: int, len2: int) -> bool:
    """True when sketches share enough hashes to call the sequences
    same-strand: shared > 0.5 * |sk1| * (len2/len1)
    (reference compareMinHashList, SeqIterator.cpp:65-86)."""
    if len(sk1) == 0 or len(sk2) == 0 or len1 == 0:
        return False
    shared = len(np.intersect1d(sk1, sk2, assume_unique=True))
    return shared > 0.5 * len(sk1) * (float(len2) / float(len1))


def same_strand(training_seq: str, contig: str) -> bool:
    """Strandness of ``contig`` vs ``training_seq``: True when the
    forward orientation already matches (reference
    IndexCreator.cpp:1158-1160 comparing training vs contig sketches)."""
    return minhash_similar(minhash_sketch(training_seq),
                           minhash_sketch(contig),
                           len(training_seq), len(contig))
