"""Genetic-code and metamer encoding tables.

A *metamer* is a 64-bit word jointly encoding an 8-residue amino-acid
translation (5 bits each, bits 63..24) and the 8 underlying DNA codons
(3 bits each, bits 23..0).  Behavior matches the reference Metabuli
encoding (reference: src/commons/GeneticCode.h:6-321, src/commons/Kmer.h:52-75)
but is laid out as flat numpy tables so the whole encode step vectorizes
on TPU (gathers over constant arrays) instead of scalar table walks.

Nucleotide 3-bit code: ``(ascii & 14) >> 1`` maps
A->0, C->1, T->2, G->3, N->7 (case-insensitive); every other character
behaves like N (invalid).
"""

import numpy as np

# 20 amino acids in the reference ordering + stop(20); index 20 prints 'X'.
AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYVX"
STOP_AA = 20  # stop codons are *included* in metamers (only N restarts windows)

KMER_LEN = 8  # amino acids per metamer
DNA_BITS = 24  # 8 codons x 3 bits
AA_BITS = 40  # 8 residues x 5 bits
DNA_MASK = np.uint64((1 << DNA_BITS) - 1)
AA_MASK = ~DNA_MASK  # keeps the AA part (bits 63..24)
INVALID_KMER = np.uint64(0xFFFFFFFFFFFFFFFF)


def _build_nuc_code_table() -> np.ndarray:
    """ASCII -> 3-bit nucleotide code, with invalid characters forced to 7 (N).

    The reference first maps ASCII through its `atcg` whitelist (invalid ->
    '.') and then applies nuc2int; '.' maps to 7, so collapsing both steps
    into one 256-entry table is behavior-preserving.
    """
    tbl = np.full(256, 7, dtype=np.uint8)
    for ch in "ACGTacgt":
        tbl[ord(ch)] = (ord(ch) & 14) >> 1
    return tbl


def _build_complement_code_table() -> np.ndarray:
    """3-bit nucleotide code -> 3-bit code of the complement base.

    A(0)<->T(2), C(1)<->G(3), N(7)->7.  (The reference routes characters
    through the `iRCT` complement string; only A/C/G/T produce valid codes,
    every other character already behaves as N.)
    """
    tbl = np.full(8, 7, dtype=np.uint8)
    tbl[0] = 2  # A -> T
    tbl[2] = 0  # T -> A
    tbl[1] = 3  # C -> G
    tbl[3] = 1  # G -> C
    return tbl


def _build_codon_tables():
    """Build codon->AA and codon->ordinal tables, flat over 9-bit codon index.

    Index = (n0 << 6) | (n1 << 3) | n2 with 3-bit nucleotide codes.
    aa table: 0..20 for valid codons, 31 (0x1F sentinel) if any base is N.
    num table: DNA ordinal 0..7 (position of the codon within its AA's
    synonymous-codon list), 7 for invalid.
    Matches reference nuc2aa / nuc2num (src/commons/GeneticCode.h:32-194).
    """
    aa = np.full(512, 31, dtype=np.uint8)
    num = np.full(512, 7, dtype=np.uint8)

    # Codon strings per amino acid id, in reference order (standard code).
    codons_by_aa = {
        0: ["GCA", "GCC", "GCT", "GCG"],                     # A
        1: ["CGA", "CGC", "CGT", "CGG", "AGG", "AGA"],       # R
        2: ["AAC", "AAT"],                                   # N
        3: ["GAC", "GAT"],                                   # D
        4: ["TGC", "TGT"],                                   # C
        5: ["CAA", "CAG"],                                   # Q
        6: ["GAA", "GAG"],                                   # E
        7: ["GGA", "GGC", "GGT", "GGG"],                     # G
        8: ["CAC", "CAT"],                                   # H
        9: ["ATA", "ATC", "ATT"],                            # I
        10: ["CTA", "CTC", "CTT", "CTG", "TTG", "TTA"],      # L
        11: ["AAA", "AAG"],                                  # K
        12: ["ATG"],                                         # M
        13: ["TTC", "TTT"],                                  # F
        14: ["CCA", "CCC", "CCT", "CCG"],                    # P
        15: ["TCA", "TCC", "TCT", "TCG", "AGT", "AGC"],      # S
        16: ["ACA", "ACC", "ACT", "ACG"],                    # T
        17: ["TGG"],                                         # W
        18: ["TAC", "TAT"],                                  # Y
        19: ["GTA", "GTC", "GTT", "GTG"],                    # V
        20: ["TAA", "TAG", "TGA"],                           # stop
    }
    n2i = {"A": 0, "C": 1, "T": 2, "G": 3}

    def idx(codon):
        return (n2i[codon[0]] << 6) | (n2i[codon[1]] << 3) | n2i[codon[2]]

    for aa_id, codons in codons_by_aa.items():
        for c in codons:
            aa[idx(c)] = aa_id

    # DNA ordinal: by default the 2-bit code of the third base...
    for i0 in range(4):
        for i1 in range(4):
            for i2 in range(4):
                num[(i0 << 6) | (i1 << 3) | i2] = i2
    # ...with fix-ups for 6-codon families / stop so ordinals stay unique
    # within an AA (reference GeneticCode.h:174-194).
    num[idx("AGG")] = 4
    num[idx("AGA")] = 5
    num[idx("TTG")] = 4
    num[idx("TTA")] = 5
    num[idx("AGT")] = 6
    num[idx("AGC")] = 7
    num[idx("TGA")] = 5
    return aa, num


# Flat constant tables (module-level singletons; cheap, built once).
NUC_CODE = _build_nuc_code_table()           # (256,) uint8
COMP_CODE = _build_complement_code_table()   # (8,)   uint8
CODON2AA, CODON2NUM = _build_codon_tables()  # (512,) uint8 each
# fused (aa << 3) | num table: one 8-bit gather per codon on device
# instead of two (TPU gathers cost ~10 ns/element; table lookups are the
# dominant cost of the encode step)
AANUM = ((CODON2AA.astype(np.uint16) << 3) | CODON2NUM).astype(np.uint8)


def _build_hamming_table() -> np.ndarray:
    """Per-codon hamming distance between two DNA ordinals of the same AA.

    Index = (ord1 << 3) | ord2, values 0..4.  This reproduces the
    reference's hammingLookup (src/commons/KmerMatcher.h:66-70), derived
    from the actual base differences between the codons that map to each
    (AA, ordinal) pair; the reference collapsed it to one 8x8 table valid
    across AAs because ordinal assignment is consistent.
    """
    t = np.array(
        [
            [0, 1, 1, 1, 2, 1, 3, 3],
            [1, 0, 1, 1, 2, 2, 3, 2],
            [1, 1, 0, 1, 2, 2, 2, 3],
            [1, 1, 1, 0, 1, 2, 3, 3],
            [2, 2, 2, 1, 0, 1, 4, 4],
            [1, 2, 2, 2, 1, 0, 4, 4],
            [3, 3, 2, 3, 4, 4, 0, 1],
            [3, 2, 3, 3, 4, 4, 1, 0],
        ],
        dtype=np.uint8,
    )
    return t.reshape(64)


HAMMING_TABLE = _build_hamming_table()  # (64,) uint8, full values incl. 4


def seq_to_codes(seq) -> np.ndarray:
    """ASCII sequence (str or bytes) -> 3-bit nucleotide codes (uint8)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else np.asarray(seq, dtype=np.uint8)
    return NUC_CODE[arr]


def codes_revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement in 3-bit code space."""
    return COMP_CODE[codes[::-1]]


def max_covered_length(length):
    """Longest prefix usable by all six frames (reference LocalUtil.h:50-59)."""
    length = np.asarray(length)
    return length - np.choose(length % 3, [3, 4, 2])


def query_kmer_count(length, k: int = KMER_LEN):
    """K-mer slots per read over 6 frames (reference LocalUtil.h:45-48)."""
    return (max_covered_length(length) // 3 - k + 1) * 6
