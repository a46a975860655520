"""The plain classifier: its own index of the genomes, a matcher over
it, and the scalar scorer.

Index: every genome's six-frame metamers (encode.extract_target_kmers),
one entry per distinct (metamer, species), sorted by metamer; each
genome is a species of its own, so an entry's taxon is its species.

Matcher (reference KmerMatcher.cpp:251-466, compareDna :1117-1146): a
query metamer matches every entry of the same 40-bit amino-acid part
whose per-codon DNA hamming sum is at most min(2 x the least sum among
those entries, 7); the 2-bit per-codon hammings are packed codon i at
field i for a forward frame and at field 7 - i for a reverse one.
"""

import numpy as np

from .encode import extract_query_kmers, extract_target_kmers
from .genetic_code import DNA_BITS, HAMMING_TABLE, KMER_LEN, \
    max_covered_length
from .scorer import MATCH_DTYPE, Scorer, sort_matches

_DNA_MASK = np.uint64((1 << DNA_BITS) - 1)


def build_index(genomes, species_ids, syncmer, smer_len):
    """(values u64 sorted, species i32) of the genomes ([n, L] uint8 rows
    of ACGT), genome i under species_ids[i]."""
    vals, sps = [], []
    for g, sp in zip(genomes, species_ids):
        v = np.unique(extract_target_kmers(g.tobytes(), syncmer=syncmer,
                                           smer_len=smer_len))
        vals.append(v)
        sps.append(np.full(len(v), sp, dtype=np.int32))
    values = np.concatenate(vals)
    species = np.concatenate(sps)
    order = np.lexsort((species, values))
    return values[order], species[order]


class Reference:
    """classify(seq1, seq2=None) -> scorer.Result of one read or pair."""

    def __init__(self, values, species, taxonomy, *, syncmer, smer_len,
                 seq_mode, min_score, min_sp_score, precision="float32",
                 **scorer_kw):
        self.values = values
        self.species = species
        self.aa = values >> np.uint64(DNA_BITS)
        self.syncmer, self.smer_len = syncmer, smer_len
        self.scorer = Scorer(taxonomy, syncmer, smer_len, seq_mode,
                             min_score, min_sp_score, precision=precision,
                             **scorer_kw)

    def matches(self, kmers, pos, frames):
        """MATCH_DTYPE rows of one read's query metamers, sorted."""
        q_aa = kmers >> np.uint64(DNA_BITS)
        lo = np.searchsorted(self.aa, q_aa, side="left")
        hi = np.searchsorted(self.aa, q_aa, side="right")
        n = hi - lo
        qi = np.repeat(np.arange(len(kmers)), n)
        if not len(qi):
            return np.zeros(0, MATCH_DTYPE)
        first = np.cumsum(n) - n
        ent = np.repeat(lo, n) + (np.arange(len(qi)) - np.repeat(first, n))
        t_dna = (self.values[ent] & _DNA_MASK).astype(np.int64)
        q_dna = (kmers[qi] & _DNA_MASK).astype(np.int64)
        fwd = frames[qi] < 3
        hsum = np.zeros(len(qi), np.int64)
        rh = np.zeros(len(qi), np.int64)
        for i in range(KMER_LEN):
            h = HAMMING_TABLE[(((q_dna >> (3 * i)) & 7) << 3)
                              | ((t_dna >> (3 * i)) & 7)].astype(np.int64)
            hsum += h
            rh |= np.where(fwd, (h & 3) << (2 * i),
                           (h & 3) << (2 * (KMER_LEN - 1 - i)))
        least = np.minimum.reduceat(hsum, first[n > 0])
        cutoff = np.minimum(2 * np.repeat(least, n[n > 0]), 7)
        keep = hsum <= cutoff
        m = np.zeros(int(keep.sum()), MATCH_DTYPE)
        m["qid"] = 1
        m["pos"] = pos[qi][keep]
        m["frame"] = frames[qi][keep]
        m["taxid"] = self.species[ent][keep]
        m["species"] = self.species[ent][keep]
        m["dna"] = t_dna[keep]
        m["rh"] = rh[keep]
        m["ham"] = hsum[keep]
        return sort_matches(m)

    def classify(self, seq1, seq2=None):
        k, p, f = extract_query_kmers(seq1, self.syncmer, self.smer_len)
        qlen = int(max_covered_length(len(seq1)))
        if seq2 is not None and len(seq2):
            k2, p2, f2 = extract_query_kmers(seq2, self.syncmer,
                                             self.smer_len,
                                             pos_offset=qlen + 3)
            k, p, f = (np.concatenate([k, k2]), np.concatenate([p, p2]),
                       np.concatenate([f, f2]))
            qlen += int(max_covered_length(len(seq2)))
        return self.scorer.classify_read(self.matches(k, p, f), qlen)
