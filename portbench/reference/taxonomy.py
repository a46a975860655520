"""A plain taxonomy tree: parent links and ranks, LCA by walking up.

Internal ids as the program numbers them: 0 unclassified, 1 the root
(its own parent), then the families, the genera and the species.  The benchmark's
configurations hold no Eukaryota node, so no species takes the
eukaryotic path depth.
"""


class Taxonomy:
    def __init__(self, parent, ranks):
        self.parent = [int(p) for p in parent]
        self.ranks = list(ranks)

    def species_of(self, t):
        while t > 1 and self.ranks[t] != "species":
            t = self.parent[t]
        return t if t > 1 else 0

    def _lineage(self, t):
        out = [t]
        while self.parent[t] != t:
            t = self.parent[t]
            out.append(t)
        return out

    def lca_pair(self, a, b):
        up = set(self._lineage(a))
        for t in self._lineage(b):
            if t in up:
                return t
        return 1

    def lca_list(self, ids):
        out = ids[0]
        for t in ids[1:]:
            out = self.lca_pair(out, t)
        return out
