"""Genetic-code and metamer encoding tables (frozen copy of the port's
ops/genetic_code.py; reference src/commons/GeneticCode.h:6-321,
src/commons/Kmer.h:52-75).

A metamer is a 64-bit word: an 8-residue amino-acid translation (5 bits
each, bits 63..24) and the 8 underlying DNA codons (3 bits each, bits
23..0).  Nucleotide 3-bit code: A->0, C->1, T->2, G->3, anything else 7.
"""

import numpy as np

KMER_LEN = 8     # amino acids per metamer
DNA_BITS = 24    # 8 codons x 3 bits


def _nuc_code_table():
    tbl = np.full(256, 7, dtype=np.uint8)
    for ch in "ACGTacgt":
        tbl[ord(ch)] = (ord(ch) & 14) >> 1
    return tbl


def _complement_code_table():
    tbl = np.full(8, 7, dtype=np.uint8)
    tbl[0], tbl[2], tbl[1], tbl[3] = 2, 0, 3, 1
    return tbl


def _codon_tables():
    """codon -> AA id (31 when a base is N) and codon -> DNA ordinal (its
    place among its AA's synonymous codons), over the 9-bit codon index
    (n0 << 6) | (n1 << 3) | n2."""
    aa = np.full(512, 31, dtype=np.uint8)
    num = np.full(512, 7, dtype=np.uint8)
    codons_by_aa = {
        0: ["GCA", "GCC", "GCT", "GCG"],
        1: ["CGA", "CGC", "CGT", "CGG", "AGG", "AGA"],
        2: ["AAC", "AAT"],
        3: ["GAC", "GAT"],
        4: ["TGC", "TGT"],
        5: ["CAA", "CAG"],
        6: ["GAA", "GAG"],
        7: ["GGA", "GGC", "GGT", "GGG"],
        8: ["CAC", "CAT"],
        9: ["ATA", "ATC", "ATT"],
        10: ["CTA", "CTC", "CTT", "CTG", "TTG", "TTA"],
        11: ["AAA", "AAG"],
        12: ["ATG"],
        13: ["TTC", "TTT"],
        14: ["CCA", "CCC", "CCT", "CCG"],
        15: ["TCA", "TCC", "TCT", "TCG", "AGT", "AGC"],
        16: ["ACA", "ACC", "ACT", "ACG"],
        17: ["TGG"],
        18: ["TAC", "TAT"],
        19: ["GTA", "GTC", "GTT", "GTG"],
        20: ["TAA", "TAG", "TGA"],
    }
    n2i = {"A": 0, "C": 1, "T": 2, "G": 3}

    def idx(codon):
        return (n2i[codon[0]] << 6) | (n2i[codon[1]] << 3) | n2i[codon[2]]

    for aa_id, codons in codons_by_aa.items():
        for c in codons:
            aa[idx(c)] = aa_id
    for i0 in range(4):
        for i1 in range(4):
            for i2 in range(4):
                num[(i0 << 6) | (i1 << 3) | i2] = i2
    for codon, n in (("AGG", 4), ("AGA", 5), ("TTG", 4), ("TTA", 5),
                     ("AGT", 6), ("AGC", 7), ("TGA", 5)):
        num[idx(codon)] = n
    return aa, num


NUC_CODE = _nuc_code_table()
COMP_CODE = _complement_code_table()
CODON2AA, CODON2NUM = _codon_tables()

# per-codon hamming distance between two DNA ordinals of one AA, index
# (ord1 << 3) | ord2 (reference KmerMatcher.h:66-70)
HAMMING_TABLE = np.array(
    [[0, 1, 1, 1, 2, 1, 3, 3],
     [1, 0, 1, 1, 2, 2, 3, 2],
     [1, 1, 0, 1, 2, 2, 2, 3],
     [1, 1, 1, 0, 1, 2, 3, 3],
     [2, 2, 2, 1, 0, 1, 4, 4],
     [1, 2, 2, 2, 1, 0, 4, 4],
     [3, 3, 2, 3, 4, 4, 0, 1],
     [3, 2, 3, 3, 4, 4, 1, 0]], dtype=np.uint8).reshape(64)


def seq_to_codes(seq) -> np.ndarray:
    """ASCII sequence (str, bytes or uint8 array) -> 3-bit codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) \
        else np.asarray(seq, dtype=np.uint8)
    return NUC_CODE[arr]


def codes_revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP_CODE[codes[::-1]]


def max_covered_length(length):
    """Longest prefix usable by all six frames (reference
    LocalUtil.h:50-59)."""
    length = np.asarray(length)
    return length - np.choose(length % 3, [3, 4, 2])
