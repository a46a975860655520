"""Per-read taxonomic assignment (frozen copy of the port's
classify/taxonomer.py, which mirrors reference src/commons/Taxonomer.cpp
line for line), scalar and plain.

1. per (species, frame): chain consecutive matches into paths by a DP
   over positions (getMatchPaths, Taxonomer.cpp:487-648);
2. per species: greedy best-first combination of non-overlapping paths
   with overlap trimming (combineMatchPaths, :410-485); the species
   score is the sum over the read's covered length, at most 1;
3. species within tieRatio of the best -> LCA; score < minScore ->
   unclassified; score < minSpScore -> the species' parent
   (chooseBestTaxon, :130-202);
4. redundancy filter per position quotient -> per-taxon counts
   (filterRedundantMatches, :205-241), then the BFS below the species
   (lowerRankClassification, :252-313).

Steps 2 and 4 are transcribed from the port's transcription of
Taxonomer.cpp (the C++ source is not in this repository).  The copy is
frozen here, so a later change to the program's steps is held against
it; on the benchmark's configurations each species is a leaf, so the
lower-rank step returns the species on both sides.

Scores are float32 in the reference's order of additions.  `precision`
"bfloat16" rounds every score result to bfloat16 instead: the control,
the nearest precision below the float32 the configuration states.
"""

import numpy as np

MATCH_DTYPE = np.dtype([
    ("qid", np.int64), ("pos", np.uint32), ("frame", np.uint8),
    ("taxid", np.int32), ("species", np.int32), ("dna", np.uint32),
    ("rh", np.uint16), ("ham", np.uint8)])

_F3, _F2, _F05 = np.float32(3.0), np.float32(2.0), np.float32(0.5)


def sort_matches(m):
    """Reference compareMatches order (KmerMatcher.cpp:1149-1166):
    qid, species, frame, pos, hamming, dna."""
    if len(m) == 0:
        return m
    return m[np.lexsort((m["dna"], m["ham"], m["pos"], m["frame"],
                         m["species"], m["qid"]))]


def _bf16(x):
    """float32 -> the nearest bfloat16, ties to even, as float32."""
    b = int(np.float32(x).view(np.uint32))
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return np.uint32(b & 0xFFFFFFFF).view(np.float32)


class Path:
    __slots__ = ("start", "end", "score", "hamming", "depth", "rh_start",
                 "rh_end")

    def __init__(self, start, end, score, hamming, depth, rh_start, rh_end):
        self.start, self.end, self.score = start, end, score
        self.hamming, self.depth = hamming, depth
        self.rh_start, self.rh_end = rh_start, rh_end


class Result:
    """What the run compares of a read: classified or not, the taxon
    (internal id) and the score."""

    __slots__ = ("is_classified", "classification", "score")

    def __init__(self):
        self.is_classified = False
        self.classification = 0
        self.score = np.float32(0.0)


class Scorer:
    def __init__(self, taxonomy, syncmer, smer_len, seq_mode, min_score,
                 min_sp_score, min_cons_cnt=4, min_cons_cnt_euk=9,
                 tie_ratio=0.95, precision="float32"):
        self.taxonomy = taxonomy
        self.min_score = min_score
        self.min_sp_score = min_sp_score
        self.min_cons_cnt = min_cons_cnt
        self.min_cons_cnt_euk = min_cons_cnt_euk
        self.tie_ratio = tie_ratio
        if syncmer:
            self.dna_shift = (8 - smer_len) * 3
            self.max_codon_shift = 8 - smer_len
        else:
            self.dna_shift = 3
            self.max_codon_shift = 1
        self.denominator = 100 if seq_mode in (1, 2) else 1000
        if precision == "float32":
            self.r = np.float32
        elif precision == "bfloat16":
            self.r = _bf16
        else:
            raise ValueError(f"unknown precision {precision!r}")

    # -------------------------------------------------- codon scores
    def _codon_score(self, h):
        return _F3 if h == 0 else self.r(_F2 - self.r(_F05 * np.float32(h)))

    def _match_score(self, rh):
        s = np.float32(0.0)
        for cnt in range(8):
            s = self.r(s + self._codon_score((rh >> (cnt * 2)) & 3))
        return s

    def _right_score(self, rh, n):
        s = np.float32(0.0)
        for i in range(n):
            s = self.r(s + self._codon_score((rh >> (i * 2)) & 3))
        return s

    def _left_score(self, rh, n):
        s = np.float32(0.0)
        for cnt in range(n):
            s = self.r(s + self._codon_score((rh >> (14 - cnt * 2)) & 3))
        return s

    @staticmethod
    def _right_ham(rh, n):
        return sum((rh >> (i * 2)) & 3 for i in range(n))

    @staticmethod
    def _left_ham(rh, n):
        return sum((rh >> (14 - i * 2)) & 3 for i in range(n))

    # -------------------------------------------------- a read
    def classify_read(self, m, query_length):
        """m: one read's matches in compareMatches order; query_length:
        the sum of its mates' covered lengths."""
        res = Result()
        (score, taxid), best_range, lca_flag = self._best_species(
            m, query_length)
        if score == 0 or score < self.min_score:
            res.score = score
            return res
        res.is_classified = True
        res.score = score
        if lca_flag:
            res.classification = taxid
            return res
        tax_cnt = self._filter_redundant(m[best_range[0]:best_range[1]])
        if score < self.min_sp_score:
            sp = self.taxonomy.species_of(taxid)
            res.classification = self.taxonomy.parent[sp if sp else taxid]
            return res
        res.classification = self._lower_rank(tax_cnt, taxid, query_length)
        return res

    def _best_species(self, m, query_length):
        n = len(m)
        species, frame = m["species"], m["frame"]
        sp2score = []
        best_sp_score = np.float32(0.0)
        best_range = (0, 0)
        meaningful = 0
        i = 0
        while i < n:
            sp = species[i]
            sp_start = i
            paths = []
            while i < n and species[i] == sp:
                fr = frame[i]
                fr_start = i
                while i < n and species[i] == sp and frame[i] == fr:
                    i += 1
                if i - fr_start > 1:
                    self._match_paths(m, fr_start, i, paths, sp)
            if paths:
                score = min(self._combine_paths(paths, query_length),
                            np.float32(1.0))
                if score < self.min_score:
                    continue
                sp2score.append((int(sp), score))
                if score > 0:
                    meaningful += 1
                if score > best_sp_score:
                    best_sp_score = score
                    best_range = (sp_start, i)
        if meaningful == 0:
            return (np.float32(0.0), 0), best_range, False
        max_species = []
        total = np.float32(0.0)
        for sp, sc in sp2score:
            if float(sc) >= float(best_sp_score) * self.tie_ratio:
                max_species.append(sp)
                total = self.r(total + sc)
        if len(max_species) > 1:
            return ((self.r(total / np.float32(len(max_species))),
                     self.taxonomy.lca_list(max_species)), best_range, True)
        return (total, max_species[0]), best_range, False

    def _match_paths(self, m, start, end, out, species):
        min_depth = self.min_cons_cnt
        fwd = m["frame"][start] < 3
        pos = m["pos"][start:end].astype(np.int64).tolist()
        rh = m["rh"][start:end].astype(np.int64).tolist()
        ham = m["ham"][start:end].astype(np.int64).tolist()
        dna = m["dna"][start:end].astype(np.int64).tolist()
        n = end - start
        local = [Path(pos[j], pos[j] + 23, self._match_score(rh[j]), ham[j],
                      1, rh[j], rh[j]) for j in range(n)]
        connected = [False] * n
        i = 0
        curr_pos = pos[0]
        cur_s = i
        while i < n and pos[i] == curr_pos:
            i += 1
        cur_e = i
        while i < n:
            next_pos = pos[i]
            nxt_s = i
            while i < n and pos[i] == next_pos:
                i += 1
            nxt_e = i
            shift = (next_pos - curr_pos) // 3
            if 0 < shift <= self.max_codon_shift:
                mask24 = (1 << (24 - 3 * shift)) - 1
                for nxt in range(nxt_s, nxt_e):
                    inc = self._right_score(rh[nxt], shift)
                    best_path = None
                    best_score = np.float32(0.0)
                    nd = dna[nxt]
                    for cur in range(cur_s, cur_e):
                        a, b = (dna[cur], nd) if fwd else (nd, dna[cur])
                        if (a & mask24) == (b >> (3 * shift)):
                            connected[cur] = True
                            lp = local[cur]
                            if lp.score > best_score:
                                best_path = lp
                                best_score = lp.score
                    if best_path is not None:
                        p = local[nxt]
                        p.start = best_path.start
                        p.score = self.r(best_path.score + inc)
                        p.hamming = best_path.hamming + self._right_ham(
                            rh[nxt], shift)
                        p.depth = best_path.depth + shift
                        p.rh_start = best_path.rh_start
            for cur in range(cur_s, cur_e):
                if not connected[cur] and local[cur].depth >= min_depth:
                    out.append(local[cur])
            if i == n:
                for nxt in range(nxt_s, nxt_e):
                    if local[nxt].depth >= min_depth:
                        out.append(local[nxt])
            cur_s, cur_e, curr_pos = nxt_s, nxt_e, next_pos

    def _combine_paths(self, paths, read_length):
        paths.sort(key=lambda p: (-float(p.score), p.hamming, -p.start))
        combined = []
        score = np.float32(0.0)
        for p in paths:
            if not combined:
                combined.append(p)
                score = self.r(score + p.score)
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
                    if p.start < c.start:
                        p.end = c.start - 1
                        p.hamming = max(0, p.hamming - self._right_ham(
                            p.rh_end, ov // 3))
                        p.score = self.r(self.r(
                            p.score - self._right_score(p.rh_end, ov // 3))
                            - np.float32(ov % 3))
                    else:
                        p.start = c.end + 1
                        p.hamming = max(0, p.hamming - self._left_ham(
                            p.rh_start, ov // 3))
                        p.score = self.r(self.r(
                            p.score - self._left_score(p.rh_start, ov // 3))
                            - np.float32(ov % 3))
                    continue
                overlapped = True
                break
            if not overlapped:
                combined.append(p)
                score = self.r(score + p.score)
        return self.r(score / np.float32(read_length))

    def _filter_redundant(self, m):
        best_tax, best_ham = {}, {}
        for p, h, t in zip(m["pos"].tolist(), m["ham"].tolist(),
                           m["taxid"].tolist()):
            q = p // self.dna_shift
            if q not in best_ham or h < best_ham[q]:
                best_ham[q] = h
                best_tax[q] = t
            elif h == best_ham[q]:
                best_tax[q] = self.taxonomy.lca_pair(best_tax[q], t)
        tax_cnt = {}
        for t in best_tax.values():
            tax_cnt[t] = tax_cnt.get(t, 0) + 1
        return tax_cnt

    def _lower_rank(self, tax_cnt, sp_taxid, query_length):
        parent = self.taxonomy.parent
        min_match = (query_length - 1) // self.denominator
        clade_cnt, children = {}, {}
        for t, c in tax_cnt.items():
            node = t
            clade_cnt[node] = clade_cnt.get(node, 0) + c
            while node != sp_taxid:
                par = parent[node]
                if node not in children.setdefault(par, []):
                    children[par].append(node)
                clade_cnt[par] = clade_cnt.get(par, 0) + c
                node = par
                if node == parent[node]:
                    break
        node = sp_taxid
        while True:
            ch = children.get(node, [])
            if not ch:
                return node
            best_children = []
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
