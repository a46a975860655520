"""Batch-vectorized taxonomic assignment (numpy), reference-exact.

Same semantics as classify/taxonomer.py (which mirrors the reference
src/commons/Taxonomer.cpp line-for-line) but restructured from per-read
Python loops into whole-batch array passes:

* the per-(read, species, frame) path DP becomes a sweep over pos-group
  *ranks*: all matches whose pos-group is the r-th of its frame group
  are relaxed together against the (r-1)-th groups, so the sequential
  dependency is only W rounds deep (W = windows per read) while each
  round is fully vectorized across the batch;
* float32 accumulation order per path is preserved (score[pred] + inc
  with inc built by the same f32 add sequence), so scores match the
  scalar implementation bit-for-bit;
* redundancy filtering (min-hamming per position quotient, ties -> LCA)
  becomes grouped reductions keyed by (read, quotient);
* only the greedy path-combination and the sub-species BFS remain as
  small host loops over paths / taxon counts (both tiny per read).

This pass structure is the blueprint for the on-device (Pallas
segmented-scan) version; tests pin equivalence against the scalar
oracle (tests/test_taxonomer_vec.py).
"""

from typing import Dict, List

import numpy as np

from .taxonomer import MatchPath, ReadResult, Taxonomer


def _f32(x):
    return np.float32(x)


_NATIVE_COMBINE = None


def _native_combine():
    """The C++ greedy combine (native/hostscore.cpp) or None.

    The numpy version needs K^2 masked rounds (K = max paths/run) at
    ~10 us numpy dispatch each; the scalar C++ loop does the identical
    f32 arithmetic in ~50 ns/path."""
    global _NATIVE_COMBINE
    if _NATIVE_COMBINE is None:
        try:
            from . import native_score

            _NATIVE_COMBINE = native_score.combine_paths_batch \
                if native_score.available() else False
        except Exception:
            _NATIVE_COMBINE = False
    return _NATIVE_COMBINE


def _match_scores_vec(rh: np.ndarray) -> np.ndarray:
    """Vectorized Match::getScore with reference f32 accumulation order."""
    score = np.zeros(len(rh), dtype=np.float32)
    for cnt in range(8):
        h = (rh >> np.uint16(cnt * 2)) & np.uint16(3)
        inc = np.where(h == 0, _f32(3.0), _f32(2.0) - _f32(0.5) * h.astype(np.float32))
        score = score + inc.astype(np.float32)
    return score


def _score_increment_vec(rh: np.ndarray, shift: np.ndarray, max_shift: int) -> np.ndarray:
    s = np.zeros(len(rh), dtype=np.float32)
    for i in range(max_shift):
        active = i < shift
        h = (rh >> np.uint16(i * 2)) & np.uint16(3)
        inc = np.where(h == 0, _f32(3.0), _f32(2.0) - _f32(0.5) * h.astype(np.float32))
        s = np.where(active, s + inc.astype(np.float32), s)
    return s


def _ham_increment_vec(rh: np.ndarray, shift: np.ndarray, max_shift: int) -> np.ndarray:
    s = np.zeros(len(rh), dtype=np.int64)
    for i in range(max_shift):
        s += np.where(i < shift, (rh >> np.uint16(i * 2)) & np.uint16(3), 0)
    return s


def _part_score_vec(rh, rng, left: bool):
    """Vectorized _left/_right_part_score: same f32 add sequence,
    masked rounds instead of a data-dependent loop bound."""
    s = np.zeros(rh.shape, dtype=np.float32)
    for i in range(8):
        act = i < rng
        sh = (14 - 2 * i) if left else (2 * i)
        h = (rh >> sh) & 3
        inc = np.where(h == 0, _f32(3.0),
                       _f32(2.0) - _f32(0.5) * h.astype(np.float32))
        s = np.where(act, s + inc.astype(np.float32), s)
    return s


def _part_ham_vec(rh, rng, left: bool):
    s = np.zeros(rh.shape, dtype=np.int64)
    for i in range(8):
        sh = (14 - 2 * i) if left else (2 * i)
        s += np.where(i < rng, (rh >> sh) & 3, 0)
    return s


def _combine_paths_batch(paths, starts, cnts):
    """Vectorized combineMatchPaths (reference Taxonomer.cpp:410-468)
    across many (read, species) runs at once.

    starts/cnts: per-run first path index and path count into the flat
    ``paths`` arrays.  Replays the greedy best-score-first selection with
    <24 nt overlap trimming (trimMatchPath, Taxonomer.cpp:475-485) as
    K x K masked rounds over [n_runs] lanes — K = max paths per run is
    small, so this is ~K^2 cheap vector ops instead of a Python loop
    building MatchPath objects per run.  Returns the f32 score sums in
    the scalar code's accumulation order.
    """
    R = len(starts)
    K = int(cnts.max())
    n = len(paths["start"])
    rows = np.minimum(starts[:, None] + np.arange(K)[None, :], n - 1)
    valid = np.arange(K)[None, :] < cnts[:, None]

    ps = paths["start"][rows].astype(np.int64)
    pe = paths["end"][rows].astype(np.int64)
    psc = paths["score"][rows].astype(np.float32)
    pham = paths["hamming"][rows].astype(np.int64)
    prhs = paths["rh_start"][rows].astype(np.int64)
    prhe = paths["rh_end"][rows].astype(np.int64)

    # per-run stable sort by (-score, hamming, -start) — the scalar
    # list.sort key with float(p.score) (exact f32->f64)
    rid = np.broadcast_to(np.arange(R)[:, None], (R, K))
    order = np.lexsort((
        (-ps).ravel(), pham.ravel(), (-psc.astype(np.float64)).ravel(),
        (~valid).ravel(), rid.ravel()))
    order = order.reshape(R, K) - (np.arange(R) * K)[:, None]
    take = lambda a: np.take_along_axis(a, order, axis=1)
    ps, pe, psc, pham, prhs, prhe, valid = map(
        take, (ps, pe, psc, pham, prhs, prhe, valid))

    # fast path: runs whose paths are pairwise disjoint never trim or
    # drop — the greedy total is just the f32 sum in sorted order.  Check
    # by a per-run interval sweep (sort by start, running-max end vs next
    # start); the K-round masked adds below reproduce the scalar
    # accumulation order exactly.
    s_ord = np.argsort(np.where(valid, ps, np.iinfo(np.int64).max),
                       axis=1, kind="stable")
    ss = np.take_along_axis(ps, s_ord, axis=1)
    se = np.take_along_axis(np.where(valid, pe, np.int64(-1) << 60),
                            s_ord, axis=1)
    run_max_e = np.maximum.accumulate(se, axis=1)
    disjoint = ~(run_max_e[:, :-1] >= ss[:, 1:]).any(axis=1) if K > 1 \
        else np.ones(R, dtype=bool)

    total = np.zeros(R, dtype=np.float32)
    free = np.nonzero(disjoint)[0]
    if len(free):
        tot_f = np.zeros(len(free), dtype=np.float32)
        v_f = valid[free]
        sc_f = psc[free]
        for k in range(K):
            tot_f = np.where(v_f[:, k], tot_f + sc_f[:, k], tot_f)
        total[free] = tot_f
    hard = np.nonzero(~disjoint)[0]
    if len(hard) == 0:
        return total
    total[hard] = _combine_hard(ps[hard], pe[hard], psc[hard],
                                prhs[hard], prhe[hard], valid[hard])
    return total


def _combine_hard(ps, pe, psc, prhs, prhe, valid):
    """K^2 greedy rounds for one bucket of overlapping runs."""
    R, K = ps.shape

    kept_s = np.zeros((R, K), dtype=np.int64)
    kept_e = np.zeros((R, K), dtype=np.int64)
    kept_n = np.zeros(R, dtype=np.int64)
    total_h = np.zeros(R, dtype=np.float32)

    for k in range(K):
        cs_k = ps[:, k].copy()
        ce_k = pe[:, k].copy()
        sc_k = psc[:, k].copy()
        rhs_k = prhs[:, k]
        rhe_k = prhe[:, k]
        alive = valid[:, k]
        for j in range(k):
            cj_ok = alive & (j < kept_n)
            cs, ce = kept_s[:, j], kept_e[:, j]
            inter = cj_ok & ~(ce_k < cs) & ~(ce < cs_k)
            ov = np.minimum(ce_k, ce) - np.maximum(cs_k, cs) + 1
            full = inter & (ov == ce_k - cs_k + 1)
            trim = inter & ~full & (ov < 24)
            alive = alive & ~(full | (inter & ~full & (ov >= 24)))
            ti = np.nonzero(trim)[0]
            if len(ti) == 0:
                continue
            # trims are rare: run the masked-round part scores on the
            # trimmed rows only, not the whole lane set
            left_side = cs_k[ti] < cs[ti]
            rng = ov[ti] // 3
            tail = (ov[ti] % 3).astype(np.float32)
            part = np.where(left_side,
                            _part_score_vec(rhe_k[ti], rng, left=False),
                            _part_score_vec(rhs_k[ti], rng, left=True))
            sc_k[ti] = ((sc_k[ti] - part) - tail).astype(np.float32)
            ce_k[ti] = np.where(left_side, cs[ti] - 1, ce_k[ti])
            cs_k[ti] = np.where(left_side, cs_k[ti], ce[ti] + 1)
        acc = alive
        if acc.any():
            slot = kept_n
            ridx = np.nonzero(acc)[0]
            kept_s[ridx, slot[ridx]] = cs_k[ridx]
            kept_e[ridx, slot[ridx]] = ce_k[ridx]
            kept_n = kept_n + acc
            total_h = np.where(acc, total_h + sc_k, total_h)
    return total_h


class VectorTaxonomer(Taxonomer):
    """Drop-in Taxonomer that classifies a whole batch in array passes."""

    def classify_batch(self, m: np.ndarray, query_lengths: np.ndarray,
                       n_reads: int) -> List[ReadResult]:
        """m: MATCH_DTYPE for the whole batch in compareMatches order;
        query_lengths: int per 1-based read id (index 0 unused)."""
        results = [ReadResult() for _ in range(n_reads)]
        if len(m) == 0:
            return results

        paths = self._dp_paths(m)
        self._assign(m, paths, query_lengths, results)
        return results

    # ------------------------------------------------------------------ #
    def _dp_paths(self, m: np.ndarray):
        n = len(m)
        qid = m["qid"].astype(np.int64)
        species = m["species"].astype(np.int64)
        frame = m["frame"].astype(np.int64)
        pos = m["pos"].astype(np.int64)
        dna = m["dna"].astype(np.int64)
        rh = m["rh"]

        # frame groups (qid, species, frame) and pos groups within them
        new_gf = np.ones(n, dtype=bool)
        new_gf[1:] = (qid[1:] != qid[:-1]) | (species[1:] != species[:-1]) | (frame[1:] != frame[:-1])
        gf = np.cumsum(new_gf) - 1
        new_pg = new_gf.copy()
        new_pg[1:] |= pos[1:] != pos[:-1]
        pg = np.cumsum(new_pg) - 1

        pg_start = np.nonzero(new_pg)[0]
        pg_end = np.append(pg_start[1:], n)
        pg_gf = gf[pg_start]
        pg_pos = pos[pg_start]
        n_pg = len(pg_start)

        # pos-group rank within its frame group
        gf_first_pg = np.zeros(gf[-1] + 1, dtype=np.int64)
        first_pg_mask = np.ones(n_pg, dtype=bool)
        first_pg_mask[1:] = pg_gf[1:] != pg_gf[:-1]
        gf_first_pg[pg_gf[first_pg_mask]] = np.nonzero(first_pg_mask)[0]
        pg_rank = np.arange(n_pg) - gf_first_pg[pg_gf]

        # frame-group stats: size and #pos-groups
        gf_size = np.bincount(gf, minlength=gf[-1] + 1)
        gf_npg = np.bincount(pg_gf, minlength=gf[-1] + 1)

        # DP state (per match)
        score = _match_scores_vec(rh)
        depth = np.ones(n, dtype=np.int64)
        hamming = m["ham"].astype(np.int64)
        start = pos.copy()
        rh_start = rh.astype(np.int64).copy()
        connected = np.zeros(n, dtype=bool)

        # eligible frame groups: size > 1 (reference getBestSpeciesMatches
        # calls getMatchPaths only then)
        gf_ok = gf_size > 1

        # per-pos-group: shift vs previous group (same gf)
        prev_pg_same = np.zeros(n_pg, dtype=bool)
        prev_pg_same[1:] = pg_gf[1:] == pg_gf[:-1]
        shift_pg = np.zeros(n_pg, dtype=np.int64)
        shift_pg[1:] = (pg_pos[1:] - pg_pos[:-1]) // 3
        link_ok = prev_pg_same & (shift_pg > 0) & (shift_pg <= self.max_codon_shift)

        pg_size = pg_end - pg_start
        p_max = int(pg_size.max()) if n_pg else 1
        max_rank = int(pg_rank.max()) if n_pg else 0

        mask24 = np.int64((1 << 24) - 1)
        fwd_frame = frame < 3

        match_pg = pg  # per-match pos-group id
        for r in range(1, max_rank + 1):
            sel_pg = np.nonzero((pg_rank == r) & link_ok & gf_ok[pg_gf])[0]
            if len(sel_pg) == 0:
                continue
            # expand pos-group spans to match indices (vectorized ragged)
            cnts = pg_size[sel_pg]
            base = np.repeat(pg_start[sel_pg], cnts)
            offs = np.arange(cnts.sum()) - np.repeat(np.cumsum(cnts) - cnts, cnts)
            mi = base + offs  # match indices at rank r, [K]
            gpi = np.repeat(sel_pg, cnts)  # their pos-group ids

            prev = gpi - 1
            p_lo = pg_start[prev]
            p_cnt = pg_size[prev]
            sh = shift_pg[gpi]

            # candidate predecessors [K, p_max]
            pc = np.arange(p_max)[None, :]
            pidx = p_lo[:, None] + pc
            pmask = pc < p_cnt[:, None]
            pidx = np.minimum(pidx, n - 1)

            nd = dna[mi][:, None]
            cd = dna[pidx]
            shk = sh[:, None]
            m24 = (np.int64(1) << (np.int64(24) - 3 * shk)) - 1
            fwd = fwd_frame[mi][:, None]
            if self.kmer_format == 2:
                a = np.where(fwd, cd, nd)
                b = np.where(fwd, nd, cd)
                ok = (a & m24) == (b >> (3 * shk))
            else:
                a = np.where(fwd, cd, nd)
                b = np.where(fwd, nd, cd)
                ok = (a >> (3 * shk)) == (b & m24)
            ok &= pmask

            # connected |= any(ok) per predecessor
            np.logical_or.at(connected, pidx[ok], True)

            any_ok = ok.any(axis=1)
            pscore = np.where(ok, score[pidx], -np.inf)
            best_c = np.argmax(pscore, axis=1)  # first max (reference order)
            bp = pidx[np.arange(len(mi)), best_c]

            inc = _score_increment_vec(rh[mi], sh, self.max_codon_shift)
            hinc = _ham_increment_vec(rh[mi], sh, self.max_codon_shift)

            score[mi] = np.where(any_ok, (score[bp] + inc).astype(np.float32), score[mi])
            depth[mi] = np.where(any_ok, depth[bp] + sh, depth[mi])
            hamming[mi] = np.where(any_ok, hamming[bp] + hinc, hamming[mi])
            start[mi] = np.where(any_ok, start[bp], start[mi])
            rh_start[mi] = np.where(any_ok, rh_start[bp], rh_start[mi])

        # emission
        next_pg_same = np.zeros(n_pg, dtype=bool)
        next_pg_same[:-1] = pg_gf[:-1] == pg_gf[1:]
        is_last_pg = ~next_pg_same

        # min depth per match: euk species get min_cons_cnt_euk
        min_depth = np.full(n, self.min_cons_cnt, dtype=np.int64)
        if self.euk_id:
            uniq_sp = np.unique(species)
            euk_sp = uniq_sp[np.asarray(self.taxonomy.is_ancestor(self.euk_id, uniq_sp)).reshape(-1)]
            if len(euk_sp):
                min_depth[np.isin(species, euk_sp)] = self.min_cons_cnt_euk

        emit = (gf_npg[gf] >= 2) & (depth >= min_depth) & (is_last_pg[match_pg] | ~connected)
        emit &= gf_ok[gf]

        idx = np.nonzero(emit)[0]
        return {
            "idx": idx,
            "start": start[idx],
            "end": pos[idx] + 23,
            "score": score[idx],
            "hamming": hamming[idx],
            "depth": depth[idx],
            "rh_start": rh_start[idx],
            "rh_end": rh[idx].astype(np.int64),
            "qid": qid[idx],
            "species": species[idx],
        }

    # ------------------------------------------------------------------ #
    def _filter_redundant_batch(self, m, spans):
        """Vectorized filterRedundantMatches over many reads at once.

        spans: list of (rid, lo, hi) best-species match ranges.  Per
        (read, pos//dnaShift) quotient keep the min-hamming matches; the
        kept taxid is the LCA of all matches achieving the min (the
        reference's sequential update reduces to exactly this,
        Taxonomer.cpp:216-234).  Returns {rid: {taxid: count}}.
        """
        if not spans:
            return {}
        lens = np.array([hi - lo for _, lo, hi in spans], dtype=np.int64)
        base = np.repeat(np.array([lo for _, lo, _ in spans], dtype=np.int64), lens)
        offs = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
        rows = base + offs
        rid = np.repeat(np.array([r for r, _, _ in spans], dtype=np.int64), lens)
        return self.filter_redundant_arrays(
            rid, m["pos"][rows].astype(np.int64), m["ham"][rows].astype(np.int64),
            m["taxid"][rows].astype(np.int64))

    def filter_redundant_arrays(self, rid, pos, ham, tax):
        """Core of the batched redundancy filter on flat arrays
        (rows already restricted to each read's best species)."""
        quot = pos // self.dna_shift

        # group = (rid, quot); min hamming per group
        order = np.lexsort((ham, quot, rid))
        r_s, q_s, h_s, t_s = rid[order], quot[order], ham[order], tax[order]
        new_g = np.ones(len(r_s), dtype=bool)
        new_g[1:] = (r_s[1:] != r_s[:-1]) | (q_s[1:] != q_s[:-1])
        gid = np.cumsum(new_g) - 1
        n_groups = int(gid[-1]) + 1 if len(gid) else 0
        min_h = h_s[new_g]  # first of each group = min (sorted by ham)
        is_min = h_s == min_h[gid]

        lca = self.taxonomy.lca_reduce(t_s[is_min], gid[is_min], n_groups)
        g_rid = r_s[new_g]

        out: Dict[int, Dict[int, int]] = {}
        for g in range(n_groups):
            d = out.setdefault(int(g_rid[g]), {})
            t = int(lca[g])
            d[t] = d.get(t, 0) + 1
        return out

    def _assign(self, m, paths, query_lengths, results: List[ReadResult]):
        """Host flow: score paths, then redundancy-filter from the full
        match array."""
        deferred = self.score_paths(paths, query_lengths, results)

        qid = m["qid"].astype(np.int64)
        species = m["species"].astype(np.int64)
        new_sp = np.ones(len(m), dtype=bool)
        new_sp[1:] = (qid[1:] != qid[:-1]) | (species[1:] != species[:-1])
        sp_start = np.nonzero(new_sp)[0]
        sp_end = np.append(sp_start[1:], len(m))
        sp_key = qid[sp_start] * (1 << 32) + species[sp_start]

        spans = []
        for rid, qlen, score, taxid in deferred:
            srow = np.searchsorted(sp_key, rid * (1 << 32) + taxid)
            spans.append((rid, int(sp_start[srow]), int(sp_end[srow])))
        tax_cnts = self._filter_redundant_batch(m, spans)
        self.finish_with_taxcnt(deferred, tax_cnts, query_lengths, results)

    # ------------------------------------------------------------------ #
    def score_paths(self, paths, query_lengths, results: List[ReadResult]):
        """Per-read species scoring from path arrays alone.

        paths: dict of arrays ordered by (qid asc; species contiguous
        within a read; reference emission order within a species run).
        Returns deferred = [(rid, qlen, score, best_species)] for reads
        that need the redundancy-filter + lower-rank stage.

        Dispatches to the vectorized pass unless EM output is requested
        (the EM path also stores per-read top-10 (species, score^2)
        lists, which stay a small loop).
        """
        if not self.em:
            return self._score_paths_vec(paths, query_lengths, results)
        return self._score_paths_loop(paths, query_lengths, results)

    def _score_paths_vec(self, paths, query_lengths, results: List[ReadResult]):
        """Vectorized score_paths: segment reductions over species runs.

        Bit-exactness notes (numpy 2 / NEP 50 — python-float scalars are
        weak, so array expressions promote exactly like the scalar loop):
        * single-path species score = f32(score) / f32(qlen);
        * the running `sc > best` max with first-winner tie-break becomes
          segment max + first-index-equal;
        * the tie threshold is f32(float(best) * tie_ratio) per read;
        * `total` accumulates tied scores in run order with f32 adds,
          reproduced by rank-k rounds of vectorized f32 additions.
        """
        from .taxonomer import MatchPath

        n_reads = len(results)
        pq = paths["qid"]
        ps = paths["species"]
        n = len(pq)
        deferred = []
        if n == 0:
            return deferred

        new_run = np.empty(n, dtype=bool)
        new_run[0] = True
        new_run[1:] = (pq[1:] != pq[:-1]) | (ps[1:] != ps[:-1])
        run_a = np.nonzero(new_run)[0]
        run_b = np.append(run_a[1:], n)
        run_qid = pq[run_a].astype(np.int64)
        run_sp = ps[run_a].astype(np.int64)
        n_runs = len(run_a)

        qlen_f32 = query_lengths.astype(np.float32)
        sc = np.empty(n_runs, dtype=np.float32)
        single = (run_b - run_a) == 1
        si = run_a[single]
        sc[single] = paths["score"][si].astype(np.float32) / qlen_f32[run_qid[single]]
        multi = np.nonzero(~single)[0]
        if len(multi):
            cnts = run_b[multi] - run_a[multi]
            if _native_combine():
                total = _native_combine()(paths, run_a[multi], cnts)
                sc[multi] = total / qlen_f32[run_qid[multi]]
            elif int(cnts.max()) <= 32:
                total = _combine_paths_batch(paths, run_a[multi], cnts)
                sc[multi] = total / qlen_f32[run_qid[multi]]
            else:  # pathological run length: scalar fallback
                p_depth = paths.get("depth")
                for r in multi:
                    a, b = int(run_a[r]), int(run_b[r])
                    plist = [
                        MatchPath(
                            start=int(paths["start"][j]),
                            end=int(paths["end"][j]),
                            score=paths["score"][j],
                            hamming=int(paths["hamming"][j]),
                            depth=int(p_depth[j]) if p_depth is not None else 0,
                            rh_start=int(paths["rh_start"][j]),
                            rh_end=int(paths["rh_end"][j]),
                        )
                        for j in range(a, b)
                    ]
                    sc[r] = self._combine_paths(plist, int(query_lengths[run_qid[r]]))
        sc = np.minimum(sc, _f32(1.0))

        keep = ~(sc < self.min_score)
        ki = np.nonzero(keep)[0]          # kept run indices, (read, run) order
        if len(ki) == 0:
            return deferred
        kq = run_qid[ki]                  # 1-based read per kept run
        ksc = sc[ki]
        # segment starts of each read's kept runs
        seg = np.searchsorted(kq, np.arange(1, n_reads + 2))
        cnt = np.diff(seg)
        meaningful = np.bincount(kq[ksc > 0], minlength=n_reads + 1)[1:]
        live = (cnt > 0) & (meaningful > 0)
        if not live.any():
            return deferred

        best1 = np.full(n_reads + 1, -np.inf, dtype=np.float32)
        np.maximum.at(best1, kq, ksc)
        best = best1[1:]

        thr = (best.astype(np.float64) * self.tie_ratio).astype(np.float32)
        tiem = ksc >= thr[kq - 1]
        tp = np.nonzero(tiem)[0]
        tq = kq[tp]
        tie_cnt = np.bincount(tq, minlength=n_reads + 1)[1:]
        tseg = np.searchsorted(tq, np.arange(1, n_reads + 1))
        within = np.arange(len(tp)) - tseg[tq - 1]
        total = np.zeros(n_reads + 1, dtype=np.float32)
        for k in range(int(within.max()) + 1 if len(tp) else 0):
            selk = within == k
            total[tq[selk]] = total[tq[selk]] + ksc[tp[selk]]

        # LCA of tied species where >1 tie (vector set-LCA per read)
        lca = np.zeros(n_reads + 1, dtype=np.int64)
        multi = tie_cnt > 1
        if multi.any():
            lca_all = self.taxonomy.lca_reduce(run_sp[ki[tp]], tq,
                                               n_reads + 1)
            lca = np.asarray(lca_all)

        top_sp = run_sp[ki[np.minimum(seg[:-1], len(ki) - 1)]]
        first_tied = run_sp[ki[tp[np.minimum(tseg, max(len(tp) - 1, 0))]]] \
            if len(tp) else np.zeros(n_reads, dtype=np.int64)

        tot = total[1:]
        for r in np.nonzero(live)[0]:
            rid = r + 1
            res = results[r]
            res.species_scores = ()
            res.top_species = int(top_sp[r])
            score = tot[r]
            if tie_cnt[r] > 1:
                sc_avg = score / _f32(int(tie_cnt[r]))
                res.score = float(sc_avg)
                if sc_avg == 0 or sc_avg < self.min_score:
                    continue
                res.is_classified = True
                res.classification = int(lca[rid])
                continue
            if score == 0 or score < self.min_score:
                res.score = float(score)
                continue
            deferred.append((rid, int(query_lengths[rid]), score,
                             int(first_tied[r])))
        return deferred

    def _score_paths_loop(self, paths, query_lengths, results: List[ReadResult]):
        """Scalar per-read loop (EM mode: also stores top-10 species)."""
        n_reads = len(results)
        # paths arrive ordered by match index = (qid, species, frame, pos)
        # order, so both read spans and species runs are contiguous
        pq = paths["qid"]
        ps = paths["species"]
        read_bounds = np.searchsorted(pq, np.arange(1, n_reads + 2))
        sp_run_start = np.nonzero(
            np.concatenate([[True], (pq[1:] != pq[:-1]) | (ps[1:] != ps[:-1])])
        )[0] if len(pq) else np.zeros(0, np.int64)
        sp_run_end = np.append(sp_run_start[1:], len(pq))

        p_start = paths["start"]
        p_end = paths["end"]
        p_score = paths["score"]
        p_ham = paths["hamming"]
        # depth is only an emission filter; device-emitted paths omit it
        p_depth = paths.get("depth")
        if p_depth is None:
            p_depth = np.zeros(len(pq), dtype=np.int64)
        p_rhs = paths["rh_start"]
        p_rhe = paths["rh_end"]

        # iterate reads that have paths
        deferred = []  # (rid, lo, hi, qlen, score, taxid) pending tax_cnt
        for rid in range(1, n_reads + 1):
            plo, phi = read_bounds[rid - 1], read_bounds[rid]
            res = results[rid - 1]
            qlen = int(query_lengths[rid])
            if plo == phi:
                continue

            sp2score = []
            best_sp_score = _f32(0.0)
            best_sp = None
            meaningful = 0
            run0 = int(np.searchsorted(sp_run_start, plo))
            run1 = int(np.searchsorted(sp_run_start, phi))
            for run in range(run0, run1):
                a, b = int(sp_run_start[run]), int(sp_run_end[run])
                sp = ps[a]
                if b - a == 1:
                    # single-path run (the common case): combine == score/len
                    sc = _f32(p_score[a]) / _f32(qlen)
                else:
                    plist = [
                        MatchPath(
                            start=int(p_start[j]),
                            end=int(p_end[j]),
                            score=p_score[j],
                            hamming=int(p_ham[j]),
                            depth=int(p_depth[j]),
                            rh_start=int(p_rhs[j]),
                            rh_end=int(p_rhe[j]),
                        )
                        for j in range(a, b)
                    ]
                    sc = self._combine_paths(plist, qlen)
                sc = min(sc, _f32(1.0))
                if sc < self.min_score:
                    continue
                sp2score.append((int(sp), float(sc)))
                if sc > 0:
                    meaningful += 1
                if sc > best_sp_score:
                    best_sp_score = sc
                    best_sp = int(sp)

            if meaningful == 0:
                continue

            if self.em and sp2score:
                sp2score.sort(key=lambda x: -x[1])
            res.species_scores = [(s, sc * sc) for s, sc in sp2score[:10]] \
            if (self.em and sp2score) else ()
            if sp2score:
                res.top_species = sp2score[0][0]

            max_species = []
            total = _f32(0.0)
            for sp, sc in sp2score:
                if sc >= float(best_sp_score) * self.tie_ratio:
                    max_species.append(sp)
                    total = total + _f32(sc)

            if len(max_species) > 1:
                lca = int(self.taxonomy.lca_list(max_species))
                score = total / _f32(len(max_species))
                if score == 0 or score < self.min_score:
                    res.score = float(score)
                    continue
                res.is_classified = True
                res.classification = lca
                res.score = float(score)
                continue

            score, taxid = total, max_species[0]
            if score == 0 or score < self.min_score:
                res.score = float(score)
                continue

            # best species (= taxid here); redundancy filtering happens in
            # a later batched phase (host match array OR device fetch)
            deferred.append((rid, qlen, score, taxid))
        return deferred

    def finish_with_taxcnt(self, deferred, tax_cnts, query_lengths, results):
        for rid, qlen, score, taxid in deferred:
            res = results[rid - 1]
            tax_cnt = tax_cnts.get(rid, {})
            res.tax_cnt = tax_cnt
            if score < self.min_sp_score:
                spn = int(self.taxonomy.species_of(taxid))
                node = spn if spn else taxid
                res.is_classified = True
                res.classification = int(self.taxonomy.parent[node])
                res.score = float(score)
                continue
            res.is_classified = True
            res.score = float(score)
            res.classification = taxid if self.em else self._lower_rank(tax_cnt, taxid, qlen)
