"""The plain EM abundance pass (classify --em), for comparison with the
program's classify/em.run_em.

Metabuli_work's Classifier::em and reclassify (src/commons/
Classifier.cpp:210-388) in three steps:

1. every read keeps its top 10 (species, score^2) mappings
   (Taxonomer.cpp:377-386): here from the reference's own matcher and
   scorer (classify.py, scorer.py), through a Scorer subclass that notes
   each species' score as the scalar scorer computes it;
2. EM re-estimates the species' probabilities over the whole sample,
   each mapping weighted by score^2 / log(unique k-mers of its species)
   times its species' probability; the unique k-mers of a species are
   its entries in the reference's own index;
3. each read is reassigned to the LCA of the smallest set of its
   species, taken by weight, whose posterior reaches 0.5; its score is
   that set's posterior.

A loop per read and per mapping, in float64 (the scores squared as the
mapping record stores them, float32), NumPy and the standard library
only.  Departures from the C++, or what this file cannot take from it:

- the C++ source is not in the repository: the stopping rule (the L1
  change of the probabilities under 1e-6, at most 1,000 iterations),
  the probabilities under 1e-5 set to 0 after the 11th iteration, the
  counts of the EM report (probability x mapped reads, rounded half to
  even, kept from 0.5) and the order of a read's mappings (score
  descending, ties in species order, as the scorer meets them) are
  transcribed from the program's account of the C++, as scorer.py's
  steps 2 and 4 are;
- a read's mappings with equal weights keep their mapping order in step
  3 (the C++ sorts them; its order among equal weights is not known
  here);
- the LCA of step 3 walks parent links (taxonomy.py), where the C++
  uses its taxonomy's LCA: the same node on a tree.
"""

import numpy as np

from .scorer import Scorer

TOP = 10
MAX_ITER = 1000
TOL = 1e-6
FLOOR = 1e-5            # probabilities under it are set to 0 ...
FLOOR_AFTER = 10        # ... in iterations after this one
HALF = 0.5


class ListingScorer(Scorer):
    """The reference's scorer, also noting each species' score of the
    read it classifies, in the order the scorer meets the species."""

    def classify_read(self, m, query_length):
        self.noted = []
        return super().classify_read(m, query_length)

    def _match_paths(self, m, start, end, out, species):
        self._species = int(species)
        return super()._match_paths(m, start, end, out, species)

    def _combine_paths(self, paths, read_length):
        # called once a species, after the species' last _match_paths
        score = super()._combine_paths(paths, read_length)
        self.noted.append((self._species, min(score, np.float32(1.0))))
        return score


def listing(reference):
    """The reference (classify.Reference) with a ListingScorer: after
    each classify(), mappings(reference) gives the read's mappings."""
    reference.scorer.__class__ = ListingScorer
    return reference


def mappings(reference):
    """The last classified read's mappings: up to TOP (species, score^2)
    of the species at or above min_score, score descending (ties in the
    order met), none when no species scored above 0; score^2 rounded to
    float32 as the mapping record holds it."""
    kept = [(sp, sc) for sp, sc in reference.scorer.noted
            if not sc < reference.scorer.min_score]
    if not any(sc > 0 for _, sc in kept):
        return []
    kept.sort(key=lambda x: -float(x[1]))
    return [(sp, float(np.float32(float(sc) * float(sc))))
            for sp, sc in kept[:TOP]]


def unique_kmer_counts(species):
    """Entries a species of the reference's index (its species array)."""
    sp, n = np.unique(np.asarray(species), return_counts=True)
    return dict(zip(sp.tolist(), n.tolist()))


def estimate(reads, kmer_counts, max_iter=MAX_ITER, tol=TOL):
    """EM over `reads` (a list, one per read, of [(species, score^2)]).
    Returns (probabilities {species: p}, mapped reads, iterations)."""
    species = sorted({s for maps in reads for s, _ in maps})
    if not species:
        return {}, 0, 0
    factor = {}
    for s in species:
        n = kmer_counts.get(s, 0)
        factor[s] = 1.0 / float(np.log(n)) if n > 1 else 0.0
    prob = {s: 1.0 / len(species) for s in species}
    mapped = 0
    it = 0
    for it in range(max_iter):
        acc = {s: 0.0 for s in species}
        mapped = 0
        for maps in reads:
            w = [sc * factor[s] * prob[s] for s, sc in maps]
            total = 0.0
            for x in w:
                total += x
            if total > 0:
                mapped += 1
                for (s, _), x in zip(maps, w):
                    acc[s] += x / total
        new = {s: acc[s] / max(mapped, 1) for s in species}
        delta = 0.0
        for s in species:
            delta += abs(new[s] - prob[s])
        if it > FLOOR_AFTER:
            for s in species:
                if new[s] < FLOOR:
                    new[s] = 0.0
        prob = new
        if delta < tol:
            break
    return prob, mapped, it + 1


def report_counts(prob, mapped, n_reads):
    """The EM report's reads a taxon: {species: round(p x mapped)} for
    p x mapped >= 0.5, and 0 (unclassified) the rest of the n_reads."""
    out = {}
    for s, p in prob.items():
        c = p * mapped
        if p > 0 and c >= HALF:
            out[s] = int(round(c))
    out[0] = n_reads - sum(out.values())
    return out


def reclassify(reads, prob, kmer_counts, taxonomy):
    """Per read: (taxon, posterior, margin), or None when the read has
    no weight.  The taxon is the LCA of the smallest prefix of the
    read's species, by weight, whose posterior reaches 0.5, and the
    posterior is that prefix's; the margin is how far from 0.5 the
    posteriors before and after its last species lie (where a
    difference in the last bits of a sum could move the cut)."""
    out = []
    for maps in reads:
        w = []
        for s, sc in maps:
            n = kmer_counts.get(s, 0)
            f = 1.0 / float(np.log(n)) if n > 1 else 0.0
            w.append((sc * f * prob.get(s, 0.0), s))
        total = 0.0
        for x, _ in w:
            total += x
        if not total > 0:
            out.append(None)
            continue
        order = sorted(range(len(w)), key=lambda j: -w[j][0])
        kept = []
        before = after = 0.0
        for j in order:
            if not after < HALF:
                break
            kept.append(w[j][1])
            before = after
            after += w[j][0] / total
        margin = abs(before - HALF)
        if len(kept) < len(order):
            margin = min(margin, abs(after - HALF))
        out.append((taxonomy.lca_list(kept), after, margin))
    return out
