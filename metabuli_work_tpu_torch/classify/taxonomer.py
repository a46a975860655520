"""Per-read taxonomic assignment — exact reference semantics.

Implements the scoring/assignment stage (reference src/commons/
Taxonomer.cpp) over the match arrays produced by the device kernel:

1. per (species, frame): chain consecutive matches into paths via a DP
   over positions (getMatchPaths, Taxonomer.cpp:487-648); consecutiveness
   = shifted 24-bit DNA-encoding equality (isConsecutive2 for the new
   k-mer format, Taxonomer.cpp:686-699), shift <= maxCodonShift;
2. per species: greedy best-score-first combination of non-overlapping
   paths with <24 nt overlap trimming (combineMatchPaths,
   Taxonomer.cpp:410-468); species score = sum(path scores)/read length,
   capped at 1.0;
3. species within tieRatio of the best -> LCA; score < minScore ->
   unclassified; score < minSpScore -> parent of species
   (chooseBestTaxon, Taxonomer.cpp:130-202);
4. redundancy filter per position-quotient keeping min-hamming (ties ->
   LCA) -> per-taxon counts (filterRedundantMatches, Taxonomer.cpp:205-241);
5. BFS below the species while a unique child clade exceeds
   (len-1)/denominator matches (lowerRankClassification,
   Taxonomer.cpp:252-313).

Float accumulation mirrors the reference's f32 order so scores are
bit-identical.  This is the readable host implementation; the hot parts
have a vectorized counterpart planned on-device (segmented scans) that is
validated against this one.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MATCH_DTYPE = np.dtype(
    [
        ("qid", np.int64),     # 1-based read id
        ("pos", np.uint32),
        ("frame", np.uint8),
        ("taxid", np.int32),
        ("species", np.int32),
        ("dna", np.uint32),    # target 24-bit DNA encoding
        ("rh", np.uint16),     # packed per-codon 2-bit hammings
        ("ham", np.uint8),     # hamming sum
    ]
)


def sort_matches(m: np.ndarray) -> np.ndarray:
    """Total order of reference compareMatches (KmerMatcher.cpp:1149-1166).

    Packs the six fields into two u64 keys (qid|species, then
    frame|pos|ham|dna) so the lexsort runs two passes instead of six.
    Falls back to the field-wise sort when pos exceeds 24 bits
    (reads/offsets beyond 16 Mnt).
    """
    if len(m) == 0:
        return m
    pos = m["pos"].astype(np.uint64)
    if pos.max() < (1 << 24):
        k1 = (m["qid"].astype(np.uint64) << np.uint64(32)) | m["species"].astype(np.uint64)
        k2 = (
            (m["frame"].astype(np.uint64) << np.uint64(54))
            | (pos << np.uint64(30))
            | (m["ham"].astype(np.uint64) << np.uint64(24))
            | m["dna"].astype(np.uint64)
        )
        order = np.lexsort((k2, k1))
    else:
        order = np.lexsort((m["dna"], m["ham"], m["pos"], m["frame"], m["species"], m["qid"]))
    return m[order]


def _match_score(rh: int) -> np.float32:
    score = np.float32(0.0)
    for cnt in range(8):
        h = (rh >> (cnt * 2)) & 3
        score = score + (np.float32(3.0) if h == 0 else np.float32(2.0) - np.float32(0.5) * np.float32(h))
    return score


def _score_increment(rh: int, shift: int) -> np.float32:
    s = np.float32(0.0)
    for i in range(shift):
        h = (rh >> (i * 2)) & 3
        s = s + (np.float32(3.0) if h == 0 else np.float32(2.0) - np.float32(0.5) * np.float32(h))
    return s


def _hamming_increment(rh: int, shift: int) -> int:
    return sum((rh >> (i * 2)) & 3 for i in range(shift))


def _right_part_score(rh: int, rng: int) -> np.float32:
    return _score_increment(rh, rng)


def _left_part_score(rh: int, rng: int) -> np.float32:
    s = np.float32(0.0)
    for cnt in range(rng):
        h = (rh >> (14 - cnt * 2)) & 3
        s = s + (np.float32(3.0) if h == 0 else np.float32(2.0) - np.float32(0.5) * np.float32(h))
    return s


def _right_part_ham(rh: int, rng: int) -> int:
    return sum((rh >> (i * 2)) & 3 for i in range(rng))


def _left_part_ham(rh: int, rng: int) -> int:
    return sum((rh >> (14 - i * 2)) & 3 for i in range(rng))


@dataclass
class MatchPath:
    start: int
    end: int
    score: np.float32
    hamming: int
    depth: int
    rh_start: int   # packed per-codon hammings of the startMatch
    rh_end: int     # ... of the endMatch (trimming needs both,
                    # Taxonomer.cpp:475-485)


_EMPTY_TAX_CNT: Dict[int, int] = {}


class ReadResult:
    """Per-read assignment result.

    Hand-rolled __slots__ class, not a dataclass: one is created per read
    per batch and dataclass __init__ costs ~7 us each (~15 ms/batch of
    pure object construction).  tax_cnt/species_scores share immutable
    empty defaults; assign fresh containers, never mutate in place.
    """

    __slots__ = ("is_classified", "classification", "score", "hamming",
                 "tax_cnt", "top_species", "species_scores")

    def __init__(self):
        self.is_classified = False
        self.classification = 0      # internal taxid
        self.score = 0.0
        self.hamming = 0
        self.tax_cnt = _EMPTY_TAX_CNT
        self.top_species = 0
        self.species_scores = ()


class Taxonomer:
    def __init__(
        self,
        taxonomy,
        kmer_format: int = 2,
        syncmer: bool = False,
        smer_len: int = 5,
        seq_mode: int = 2,
        min_score: float = 0.0,
        min_sp_score: float = 0.0,
        min_cons_cnt: int = 4,
        min_cons_cnt_euk: int = 9,
        tie_ratio: float = 0.95,
        accession_level: int = 0,
        em: bool = False,
    ):
        self.taxonomy = taxonomy
        self.kmer_format = kmer_format
        self.min_score = min_score
        self.min_sp_score = min_sp_score
        self.min_cons_cnt = min_cons_cnt
        self.min_cons_cnt_euk = min_cons_cnt_euk
        self.tie_ratio = tie_ratio
        self.accession_level = accession_level
        self.em = em
        self.euk_id = taxonomy.eukaryota_id()
        # reference Taxonomer ctor (Taxonomer.cpp:34-48)
        if syncmer:
            self.dna_shift = (8 - smer_len) * 3
            self.max_codon_shift = 8 - smer_len
        else:
            self.dna_shift = 3
            self.max_codon_shift = 1
        self.denominator = 100 if seq_mode in (1, 2) else 1000

    # ------------------------------------------------------------------ #
    def classify_read(self, matches: np.ndarray, query_length: int) -> ReadResult:
        """matches: MATCH_DTYPE rows of ONE read, already in compareMatches
        order.  query_length = len1 + len2."""
        res = ReadResult()
        sp_score, best_range, lca_flag, sp2score = self._best_species(matches, query_length)
        # EM mapping keeps the top-10 (species, score^2) (Taxonomer.cpp:383-385)
        res.species_scores = [(s, sc * sc) for s, sc in sp2score[:10]] \
            if (self.em and sp2score) else ()
        if sp2score:
            res.top_species = sp2score[0][0]

        score, taxid = sp_score
        if score == 0 or score < self.min_score:
            res.score = float(score)
            return res

        if lca_flag:
            res.is_classified = True
            res.classification = taxid
            res.score = float(score)
            return res

        tax_cnt = self._filter_redundant(matches[best_range[0]:best_range[1]], query_length)
        res.tax_cnt = tax_cnt

        if score < self.min_sp_score:
            sp = int(self.taxonomy.species_of(taxid))
            node = sp if sp else taxid
            res.is_classified = True
            res.classification = int(self.taxonomy.parent[node])
            res.score = float(score)
            return res

        res.is_classified = True
        res.score = float(score)
        if not self.em:
            res.classification = self._lower_rank(tax_cnt, taxid, query_length)
        else:
            res.classification = taxid
        return res

    # ------------------------------------------------------------------ #
    def _best_species(self, m: np.ndarray, query_length: int):
        """Returns ((score, taxid), (range_start, range_end), lca, sp2score)."""
        n = len(m)
        sp2score: List[Tuple[int, float]] = []
        best_sp_score = np.float32(0.0)
        best_range = (0, 0)
        meaningful = 0
        i = 0
        while i < n:
            sp = m["species"][i]
            sp_start = i
            paths: List[MatchPath] = []
            while i < n and m["species"][i] == sp:
                fr = m["frame"][i]
                fr_start = i
                while i < n and m["species"][i] == sp and m["frame"][i] == fr:
                    i += 1
                if i - fr_start > 1:
                    self._match_paths(m, fr_start, i, paths, sp)
            if paths:
                score = self._combine_paths(paths, query_length)
                score = min(score, np.float32(1.0))
                if score < self.min_score:
                    continue
                sp2score.append((int(sp), float(score)))
                if score > 0:
                    meaningful += 1
                if score > best_sp_score:
                    best_sp_score = score
                    best_range = (sp_start, i)

        if meaningful == 0:
            return (np.float32(0.0), 0), best_range, False, []

        if self.em and sp2score:
            # reference sorts sp2score in place before tie selection and
            # emits squared scores for the EM mapping (Taxonomer.cpp:377-386)
            sp2score.sort(key=lambda x: -x[1])

        max_species = []
        total = np.float32(0.0)
        for sp, sc in sp2score:
            if sc >= float(best_sp_score) * self.tie_ratio:
                max_species.append(sp)
                total = total + np.float32(sc)

        if len(max_species) > 1:
            lca = self.taxonomy.lca_list(max_species)
            return (total / np.float32(len(max_species)), int(lca)), best_range, True, sp2score
        return (total, max_species[0]), best_range, False, sp2score

    # ------------------------------------------------------------------ #
    def _match_paths(self, m, start, end, out: List[MatchPath], species):
        min_depth = self.min_cons_cnt
        if self.euk_id and self.taxonomy.is_ancestor(self.euk_id, int(species)):
            min_depth = self.min_cons_cnt_euk
        fwd = m["frame"][start] < 3

        local: List[Optional[MatchPath]] = [None] * (end - start)
        connected = [False] * (end - start)

        def init_path(idx):
            return MatchPath(
                start=int(m["pos"][idx]),
                end=int(m["pos"][idx]) + 23,
                score=_match_score(int(m["rh"][idx])),
                hamming=int(m["ham"][idx]),
                depth=1,
                rh_start=int(m["rh"][idx]),
                rh_end=int(m["rh"][idx]),
            )

        i = start
        curr_pos = m["pos"][start]
        cur_s = i
        while i < end and m["pos"][i] == curr_pos:
            local[i - start] = init_path(i)
            i += 1
        cur_e = i

        while i < end:
            next_pos = m["pos"][i]
            nxt_s = i
            while i < end and m["pos"][i] == next_pos:
                local[i - start] = init_path(i)
                i += 1
            nxt_e = i

            shift = (int(next_pos) - int(curr_pos)) // 3
            if 0 < shift <= self.max_codon_shift:
                mask24 = (1 << (24 - 3 * shift)) - 1
                for nxt in range(nxt_s, nxt_e):
                    inc = _score_increment(int(m["rh"][nxt]), shift)
                    best_path = None
                    best_score = np.float32(0.0)
                    nd = int(m["dna"][nxt])
                    for cur in range(cur_s, cur_e):
                        cd = int(m["dna"][cur])
                        if self.kmer_format == 2:
                            # isConsecutive2(a, b, shift); forward passes
                            # (cur, next), reverse passes (next, cur).
                            a, b = (cd, nd) if fwd else (nd, cd)
                            ok = (a & mask24) == (b >> (3 * shift))
                        else:
                            a, b = (cd, nd) if fwd else (nd, cd)
                            ok = (a >> (3 * shift)) == (b & mask24)
                        if ok:
                            connected[cur - start] = True
                            lp = local[cur - start]
                            if lp.score > best_score:
                                best_path = lp
                                best_score = lp.score
                    if best_path is not None:
                        np_loc = local[nxt - start]
                        np_loc.start = best_path.start
                        np_loc.score = best_path.score + inc
                        np_loc.hamming = best_path.hamming + _hamming_increment(int(m["rh"][nxt]), shift)
                        np_loc.depth = best_path.depth + shift
                        np_loc.rh_start = best_path.rh_start

            for cur in range(cur_s, cur_e):
                if not connected[cur - start] and local[cur - start].depth >= min_depth:
                    out.append(local[cur - start])
            if i == end:
                for nxt in range(nxt_s, nxt_e):
                    if local[nxt - start].depth >= min_depth:
                        out.append(local[nxt - start])
            cur_s, cur_e, curr_pos = nxt_s, nxt_e, next_pos

    # ------------------------------------------------------------------ #
    def _combine_paths(self, paths: List[MatchPath], read_length: int) -> np.float32:
        paths.sort(key=lambda p: (-float(p.score), p.hamming, -p.start))
        combined: List[MatchPath] = []
        score = np.float32(0.0)
        for p in paths:
            if not combined:
                combined.append(p)
                score = score + p.score
                continue
            overlapped = False
            for c in combined:
                if p.end < c.start or c.end < p.start:
                    continue
                ov = min(p.end, c.end) - max(p.start, c.start) + 1
                if ov == p.end - p.start + 1:
                    overlapped = True
                    break
                if ov < 24:
                    # trim p against c (Taxonomer.cpp:475-485)
                    if p.start < c.start:
                        p.end = c.start - 1
                        p.hamming = max(0, p.hamming - _right_part_ham(p.rh_end, ov // 3))
                        p.score = p.score - _right_part_score(p.rh_end, ov // 3) - np.float32(ov % 3)
                    else:
                        p.start = c.end + 1
                        p.hamming = max(0, p.hamming - _left_part_ham(p.rh_start, ov // 3))
                        p.score = p.score - _left_part_score(p.rh_start, ov // 3) - np.float32(ov % 3)
                    continue
                overlapped = True
                break
            if not overlapped:
                combined.append(p)
                score = score + p.score
        return score / np.float32(read_length)

    # ------------------------------------------------------------------ #
    def _filter_redundant(self, m: np.ndarray, query_length: int) -> Dict[int, int]:
        best_tax: Dict[int, int] = {}
        best_ham: Dict[int, int] = {}
        for i in range(len(m)):
            q = int(m["pos"][i]) // self.dna_shift
            h = int(m["ham"][i])
            if q not in best_ham or h < best_ham[q]:
                best_ham[q] = h
                best_tax[q] = int(m["taxid"][i])
            elif h == best_ham[q]:
                best_tax[q] = int(self.taxonomy.lca_pair(best_tax[q], int(m["taxid"][i])))
        tax_cnt: Dict[int, int] = {}
        for q in best_tax:
            tax_cnt[best_tax[q]] = tax_cnt.get(best_tax[q], 0) + 1
        return tax_cnt

    # ------------------------------------------------------------------ #
    def _lower_rank(self, tax_cnt: Dict[int, int], sp_taxid: int, query_length: int) -> int:
        min_match = (query_length - 1) // self.denominator
        clade_cnt: Dict[int, int] = {}
        children: Dict[int, List[int]] = {}
        for t, c in tax_cnt.items():
            node = t
            clade_cnt[node] = clade_cnt.get(node, 0) + c
            while node != sp_taxid:
                par = int(self.taxonomy.parent[node])
                if node not in children.setdefault(par, []):
                    children[par].append(node)
                clade_cnt[par] = clade_cnt.get(par, 0) + c
                node = par
                if node == int(self.taxonomy.parent[node]):
                    break

        if self.accession_level == 2:
            for t in list(clade_cnt):
                rk = self.taxonomy.rank_of(t)
                if rk in ("", "accession"):
                    par = int(self.taxonomy.parent[t])
                    if par in children and t in children[par]:
                        children[par].remove(t)

        # BFS (Taxonomer.cpp:292-314): a child whose clade count is *equal*
        # to the running max also joins bestChildren, so descent happens iff
        # exactly one child has count >= min_match (with > replacing ties).
        node = sp_taxid
        while True:
            ch = children.get(node, [])
            if not ch:
                return node
            best_children: List[int] = []
            max_cnt = min_match
            for c in ch:
                cnt = clade_cnt.get(c, 0)
                if cnt > max_cnt:
                    best_children = [c]
                    max_cnt = cnt
                elif cnt == max_cnt:
                    best_children.append(c)
            if len(best_children) == 1:
                node = best_children[0]
            else:
                return node
