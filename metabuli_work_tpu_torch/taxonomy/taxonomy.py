"""NCBI-taxdump taxonomy with array-based, vectorizable LCA.

Replaces the reference's NcbiTaxonomy/TaxonomyWrapper (reference
src/commons/TaxonomyWrapper.{h,cpp}; mmseqs submodule) with a numpy
design: nodes live in dense *internal id* space (0..n-1, root = 1 like
the reference's internal numbering), and LCA is two gathers + a min via
an Euler tour + sparse-table RMQ — O(1) per pair and trivially
vectorized, so the same arrays can be shipped to a TPU kernel.

Also replicates the reference's internal<->original taxid mapping
(TaxonomyWrapper.h:70-146): databases store internal ids; reports print
original ids.
"""

import os

import numpy as np


class Taxonomy:
    """Dense-array taxonomy: parent/rank/name per internal id + O(1) LCA."""

    def __init__(self, parent, rank_idx, name_idx, rank_pool, name_pool, int2orig):
        n = len(parent)
        self.parent = np.asarray(parent, dtype=np.int32)         # [n]
        self.rank_idx = np.asarray(rank_idx, dtype=np.int32)     # [n] -> rank_pool
        self.name_idx = np.asarray(name_idx, dtype=np.int32)     # [n] -> name_pool
        self.rank_pool = list(rank_pool)
        self.name_pool = list(name_pool)
        self.int2orig = np.asarray(int2orig, dtype=np.int64)     # [n]
        self.orig2int = {int(o): i for i, o in enumerate(self.int2orig) if o >= 0}
        self._build_traversal()
        self._build_rank_ancestors()

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @classmethod
    def from_taxdump(cls, taxdump_dir):
        """Load names.dmp/nodes.dmp/merged.dmp and assign internal ids.

        Internal ids are depth-first over the tree starting at the root so
        that, like the reference's internal numbering, subtree ids are
        contiguous; id 0 is reserved as "unclassified".
        """
        nodes_path = os.path.join(taxdump_dir, "nodes.dmp")
        names_path = os.path.join(taxdump_dir, "names.dmp")
        merged_path = os.path.join(taxdump_dir, "merged.dmp")

        parent_of = {}
        rank_of = {}
        with open(nodes_path) as f:
            for line in f:
                parts = [p.strip() for p in line.rstrip("\t|\n").split("\t|\t")]
                tid, par, rank = int(parts[0]), int(parts[1]), parts[2]
                parent_of[tid] = par
                rank_of[tid] = rank

        name_of = {}
        with open(names_path) as f:
            for line in f:
                parts = [p.strip() for p in line.rstrip("\t|\n").split("\t|\t")]
                if len(parts) >= 4 and parts[3] == "scientific name":
                    name_of[int(parts[0])] = parts[1]

        merged = {}
        if os.path.exists(merged_path):
            with open(merged_path) as f:
                for line in f:
                    parts = [p.strip() for p in line.rstrip("\t|\n").split("\t|\t")]
                    if len(parts) >= 2:
                        merged[int(parts[0])] = int(parts[1])

        children = {}
        root = None
        for tid, par in parent_of.items():
            if tid == par:
                root = tid
                continue
            children.setdefault(par, []).append(tid)

        # DFS ordering; internal id of root is 1, id 0 = unclassified.
        order = []
        stack = [root]
        while stack:
            t = stack.pop()
            order.append(t)
            for c in sorted(children.get(t, []), reverse=True):
                stack.append(c)

        orig2int = {t: i + 1 for i, t in enumerate(order)}
        n = len(order) + 1

        rank_pool, rank_map = [], {}
        name_pool, name_map = [], {}

        def pool_idx(pool, mp, s):
            if s not in mp:
                mp[s] = len(pool)
                pool.append(s)
            return mp[s]

        parent = np.zeros(n, dtype=np.int32)
        rank_idx = np.zeros(n, dtype=np.int32)
        name_idx = np.zeros(n, dtype=np.int32)
        int2orig = np.full(n, -1, dtype=np.int64)
        pool_idx(rank_pool, rank_map, "no rank")
        pool_idx(name_pool, name_map, "unclassified")
        for t, i in orig2int.items():
            parent[i] = orig2int[parent_of[t]] if t != root else i
            rank_idx[i] = pool_idx(rank_pool, rank_map, rank_of[t])
            name_idx[i] = pool_idx(name_pool, name_map, name_of.get(t, str(t)))
            int2orig[i] = t
        int2orig[0] = 0

        tax = cls(parent, rank_idx, name_idx, rank_pool, name_pool, int2orig)
        tax.merged = merged
        return tax

    def with_accessions(self, accs):
        """New Taxonomy with one node appended per accession (reference
        --accession-level 1 build: IndexCreator.cpp:196-200 assigns fresh
        internal ids to accessions so k-mers can be labeled per sequence
        and lowerRankClassification can descend to them).

        accs: [(accession_name, parent_internal_id)].  Appended nodes get
        rank "accession" and fresh original taxids above the current max.
        Returns (taxonomy, {accession_name: internal_id}).
        """
        k = len(accs)
        n0 = len(self.parent)
        parent = np.concatenate(
            [self.parent, np.array([p for _, p in accs], np.int32)])
        rank_pool = list(self.rank_pool)
        if "accession" not in rank_pool:
            rank_pool.append("accession")
        r_acc = rank_pool.index("accession")
        rank_idx = np.concatenate(
            [self.rank_idx, np.full(k, r_acc, np.int32)])
        name_pool = list(self.name_pool)
        name_idx = np.concatenate(
            [self.name_idx,
             np.arange(len(name_pool), len(name_pool) + k, dtype=np.int32)])
        name_pool.extend(name for name, _ in accs)
        next_orig = int(self.int2orig.max(initial=0)) + 1
        int2orig = np.concatenate(
            [self.int2orig,
             np.arange(next_orig, next_orig + k, dtype=np.int64)])
        tax = Taxonomy(parent, rank_idx, name_idx, rank_pool, name_pool,
                       int2orig)
        tax.merged = dict(getattr(self, "merged", {}))
        return tax, {name: n0 + i for i, (name, _) in enumerate(accs)}

    def save(self, path):
        np.savez_compressed(
            path,
            parent=self.parent,
            rank_idx=self.rank_idx,
            name_idx=self.name_idx,
            rank_pool=np.array(self.rank_pool, dtype=object),
            name_pool=np.array(self.name_pool, dtype=object),
            int2orig=self.int2orig,
            merged=np.array(sorted(getattr(self, "merged", {}).items()), dtype=np.int64).reshape(-1, 2),
        )

    @classmethod
    def load(cls, path):
        z = np.load(path, allow_pickle=True)
        tax = cls(
            z["parent"], z["rank_idx"], z["name_idx"],
            [str(s) for s in z["rank_pool"]], [str(s) for s in z["name_pool"]],
            z["int2orig"],
        )
        tax.merged = {int(a): int(b) for a, b in z["merged"]}
        return tax

    # ------------------------------------------------------------------ #
    # traversal structures
    # ------------------------------------------------------------------ #
    def _build_traversal(self):
        n = len(self.parent)
        self.root = 1 if n > 1 else 0
        ch_count = np.zeros(n, dtype=np.int64)
        for i in range(2, n):
            ch_count[self.parent[i]] += 1
        # children CSR
        self.ch_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ch_count, out=self.ch_start[1:])
        self.ch_list = np.zeros(max(int(self.ch_start[-1]), 1), dtype=np.int32)
        fill = self.ch_start[:-1].copy()
        for i in range(2, n):
            p = self.parent[i]
            self.ch_list[fill[p]] = i
            fill[p] += 1

        # depth (internal ids are DFS-ordered: parent < child, so one pass)
        self.depth = np.zeros(n, dtype=np.int32)
        for i in range(2, n):
            self.depth[i] = self.depth[self.parent[i]] + 1

        # Euler tour + sparse table for O(1) LCA
        first = np.zeros(n, dtype=np.int64)
        euler = np.zeros(max(2 * n - 1, 1), dtype=np.int32)
        edepth = np.zeros(max(2 * n - 1, 1), dtype=np.int32)
        ptr = 0
        if n > 1:
            stack = [(self.root, 0)]  # (node, child cursor state via iterator)
            it_stack = [iter(self.ch_list[self.ch_start[self.root]:self.ch_start[self.root + 1]])]
            first[self.root] = 0
            euler[ptr] = self.root
            edepth[ptr] = 0
            ptr += 1
            while stack:
                node, _ = stack[-1]
                try:
                    c = next(it_stack[-1])
                except StopIteration:
                    stack.pop()
                    it_stack.pop()
                    if stack:
                        euler[ptr] = stack[-1][0]
                        edepth[ptr] = self.depth[stack[-1][0]]
                        ptr += 1
                    continue
                c = int(c)
                first[c] = ptr
                euler[ptr] = c
                edepth[ptr] = self.depth[c]
                ptr += 1
                stack.append((c, 0))
                it_stack.append(iter(self.ch_list[self.ch_start[c]:self.ch_start[c + 1]]))
        self.euler = euler[:ptr]
        self.euler_first = first
        m = max(ptr, 1)
        levels = max(int(np.ceil(np.log2(m))) + 1, 1)
        self.sparse = np.zeros((levels, m), dtype=np.int64)
        self.sparse[0] = np.arange(m)
        ed = edepth[:ptr]
        for lv in range(1, levels):
            half = 1 << (lv - 1)
            prev = self.sparse[lv - 1]
            a = prev[: m - (1 << lv) + 1] if m - (1 << lv) + 1 > 0 else prev[:0]
            b = prev[half : half + len(a)]
            take_b = ed[b] < ed[a]
            self.sparse[lv, : len(a)] = np.where(take_b, b, a)
        self.edepth = ed

    def _build_rank_ancestors(self):
        """Per-node ancestor at common ranks (species/genus/...), one pass."""
        n = len(self.parent)
        self.rank_names_cached = {}
        wanted = ["superkingdom", "domain", "phylum", "class", "order", "family", "genus", "species"]
        self.at_rank = {r: np.zeros(n, dtype=np.int32) for r in wanted}
        rank_str = [self.rank_pool[i] for i in self.rank_idx]
        for i in range(1, n):
            p = self.parent[i]
            for r in wanted:
                inh = self.at_rank[r][p] if i != self.root else 0
                self.at_rank[r][i] = i if rank_str[i] == r else inh

    # ------------------------------------------------------------------ #
    # queries (all accept scalars or arrays of internal ids)
    # ------------------------------------------------------------------ #
    def lca_pair(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        az = (a <= 0) | (a >= len(self.parent))
        bz = (b <= 0) | (b >= len(self.parent))
        a_s = np.where(az, self.root, a)
        b_s = np.where(bz, self.root, b)
        fa = self.euler_first[a_s]
        fb = self.euler_first[b_s]
        lo = np.minimum(fa, fb)
        hi = np.maximum(fa, fb)
        length = hi - lo + 1
        lv = np.zeros_like(length)
        nz = length > 1
        lv[nz] = (np.log2(length[nz])).astype(np.int64)
        i1 = self.sparse[lv, lo]
        i2 = self.sparse[lv, hi - (1 << lv) + 1]
        pick = np.where(self.edepth[i2] < self.edepth[i1], i2, i1)
        res = self.euler[pick].astype(np.int64)
        # LCA(x, 0) = x in the reference (0 entries ignored)
        res = np.where(az & bz, 0, np.where(az, b, np.where(bz, a, res)))
        return res if res.ndim else np.int64(res)

    def lca_list(self, ids):
        ids = [int(i) for i in ids if int(i) > 0]
        if not ids:
            return 0
        acc = ids[0]
        for t in ids[1:]:
            acc = int(self.lca_pair(acc, t))
        return acc

    def lca_reduce(self, values, segment_ids, num_segments):
        """Vectorized grouped LCA in one pass.

        The LCA of a SET equals the pairwise LCA of its two extremal
        members by Euler-tour first-visit position (same trick as the
        device redundancy kernel), so per segment only the min/max
        euler_first are needed — two ufunc.reduceat passes plus one
        vectorized lca_pair, instead of folding max-group-size rounds.
        Zero/invalid ids are ignored (reference LCA(x, 0) = x).
        """
        values = np.asarray(values, dtype=np.int64)
        segment_ids = np.asarray(segment_ids, dtype=np.int64)
        out = np.zeros(num_segments, dtype=np.int64)
        ok = (values > 0) & (values < len(self.parent))
        v = values[ok]
        s = segment_ids[ok]
        if not len(v):
            return out
        order = np.argsort(s, kind="stable")
        v = v[order]
        s = s[order]
        firsts = np.ones(len(s), dtype=bool)
        firsts[1:] = s[1:] != s[:-1]
        starts = np.nonzero(firsts)[0]
        sizes = np.diff(np.append(starts, len(s)))
        seg = s[starts]
        # singletons (the vast majority at DB build) are their own LCA
        single = sizes == 1
        out[seg[single]] = v[starts[single]]
        multi = ~single
        if multi.any():
            ef = self.euler_first[v]
            ef_min = np.minimum.reduceat(ef, starts)[multi]
            ef_max = np.maximum.reduceat(ef, starts)[multi]
            a = self.euler[ef_min].astype(np.int64)
            b = self.euler[ef_max].astype(np.int64)
            out[seg[multi]] = self.lca_pair(a, b)
        return out

    def is_ancestor(self, anc, node):
        """anc is ancestor-or-self of node."""
        return self.lca_pair(anc, node) == np.asarray(anc, dtype=np.int64)

    def at_rank_of(self, ids, rank):
        ids = np.asarray(ids, dtype=np.int64)
        safe = np.clip(ids, 0, len(self.parent) - 1)
        return self.at_rank[rank][safe]

    def species_of(self, ids):
        return self.at_rank_of(ids, "species")

    def genus_of(self, ids):
        return self.at_rank_of(ids, "genus")

    def rank_of(self, i):
        return self.rank_pool[self.rank_idx[int(i)]]

    def name_of(self, i):
        return self.name_pool[self.name_idx[int(i)]]

    def orig_of(self, i):
        return int(self.int2orig[int(i)]) if 0 <= int(i) < len(self.int2orig) else 0

    def to_internal(self, orig):
        orig = int(orig)
        orig = getattr(self, "merged", {}).get(orig, orig)
        return self.orig2int.get(orig, 0)

    def eukaryota_id(self):
        for cand in (2759,):
            if cand in self.orig2int:
                return self.orig2int[cand]
        for i, n in enumerate(self.name_pool):
            if n == "Eukaryota":
                idxs = np.nonzero(self.name_idx == i)[0]
                if len(idxs):
                    return int(idxs[0])
        return 0

    def num_nodes(self):
        return len(self.parent)

    def lca_lift_tables(self):
        """Binary-lifting ancestor table for device-side pairwise LCA.

        Returns (depth int32 [n], lift int32 [levels, n]) with
        lift[k][i] = 2^k-th ancestor of i (root lifts to itself).  Unlike
        the Euler sparse table (O(n log n) in euler length, too large to
        ship to HBM for big taxonomies), this is O(n log maxdepth) and a
        device LCA is ~2*levels gathers.
        """
        n = len(self.parent)
        maxd = int(self.depth.max()) if n else 0
        levels = max(int(np.ceil(np.log2(maxd + 1))) + 1, 1)
        lift = np.zeros((levels, n), dtype=np.int32)
        lift[0] = self.parent
        if n:
            lift[0, self.root] = self.root
        for k in range(1, levels):
            lift[k] = lift[k - 1][lift[k - 1]]
        return self.depth.astype(np.int32), lift
