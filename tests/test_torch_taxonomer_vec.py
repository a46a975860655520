"""The port's VectorTaxonomer against its scalar Taxonomer, with and
without EM output: every ReadResult field (species_scores and
top_species included) equal on every read, on structured random matches
and on cases built for the EM selection's edges (more than 10 kept
species, equal scores, a score on the f32-rounded tie threshold, long
multi-path runs, scores under min_score, reads without paths, pad
reads)."""

import numpy as np
import pytest

from metabuli_work_tpu_torch.classify import taxonomer_vec
from metabuli_work_tpu_torch.classify.taxonomer import (
    MATCH_DTYPE, ReadResult, Taxonomer, sort_matches)
from metabuli_work_tpu_torch.classify.taxonomer_vec import VectorTaxonomer
from metabuli_work_tpu_torch.taxonomy.taxonomy import Taxonomy

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

N_GENERA = 3
SP_PER_GENUS = 8
SPECIES = list(range(3 + N_GENERA, 3 + N_GENERA + N_GENERA * SP_PER_GENUS))


def make_tax():
    """root(1) -> superkingdom(2) -> 3 genera -> 8 species each -> one
    strain each."""
    genera = list(range(3, 3 + N_GENERA))
    parent = [0, 1, 1] + [2] * N_GENERA
    parent += [genera[i // SP_PER_GENUS] for i in range(len(SPECIES))]
    parent += SPECIES
    rank = (["no rank", "no rank", "superkingdom"] + ["genus"] * N_GENERA
            + ["species"] * len(SPECIES) + ["strain"] * len(SPECIES))
    pool = sorted(set(rank))
    n = len(parent)
    return Taxonomy(np.array(parent), np.array([pool.index(r) for r in rank]),
                    np.arange(n), pool, [f"n{i}" for i in range(n)],
                    np.arange(n))


def strain_of(sp):
    return sp + len(SPECIES)


def _ham(rh):
    return sum((rh >> (2 * c)) & 3 for c in range(8))


class Reads:
    """Match rows and query lengths built read by read."""

    def __init__(self):
        self.rows = []
        self.qlens = [0]

    def read(self, qlen):
        self.qlens.append(qlen)
        return len(self.qlens) - 1

    def chain(self, rid, sp, frame, pos0, incs, rh0=0, seed=0):
        """Consecutive matches in a forward frame: a first match of
        per-codon hammings rh0, then one match a codon whose first codon
        hamming is each of incs (0-3).  Path score = score(rh0) + the
        increments (3, 1.5, 1, 0.5 for hamming 0-3)."""
        r = np.random.default_rng(seed)
        sym = r.integers(0, 8, size=len(incs) + 9)
        rhs = [rh0] + [int(h) | (int(r.integers(0, 1 << 14)) << 2)
                       for h in incs]
        for j, rh in enumerate(rhs):
            dna = 0
            for c in range(8):
                dna = (dna << 3) | int(sym[j + c])
            tax = int(r.choice([sp, strain_of(sp)]))
            self.rows.append((rid, pos0 + 3 * j, frame, tax, sp, dna, rh,
                              _ham(rh)))

    def single(self, rid, sp, frame, pos, seed):
        r = np.random.default_rng(seed)
        rh = int(r.integers(0, 1 << 16))
        self.rows.append((rid, pos, frame, sp, sp, int(r.integers(0, 1 << 24)),
                          rh, _ham(rh)))

    def arrays(self, n_pad=0):
        m = np.zeros(len(self.rows), dtype=MATCH_DTYPE)
        for i, row in enumerate(self.rows):
            m[i] = row
        return sort_matches(m), np.array(self.qlens + [0] * n_pad)


def random_case(seed):
    """Chains of consecutive k-mers in 1-3 frames of 1-4 species a read
    plus noise matches (the JAX package's tests/test_taxonomer_vec.py
    generator, on the larger taxonomy)."""
    r = np.random.default_rng(seed)
    b = Reads()
    for _ in range(25):
        rid = b.read(150)
        for sp in r.choice(SPECIES, size=r.integers(1, 5), replace=False):
            for frame in r.choice(6, size=r.integers(1, 3), replace=False):
                n = int(r.integers(1, 12))
                b.chain(rid, int(sp), int(frame),
                        int(r.integers(0, 60)) * 3 + frame % 3,
                        r.integers(0, 4, size=n - 1).tolist(),
                        rh0=int(r.integers(0, 1 << 16)),
                        seed=int(r.integers(1 << 30)))
                for _ in range(int(r.integers(0, 3))):
                    b.single(rid, int(sp), int(frame),
                             int(r.integers(0, 60)) * 3 + frame % 3,
                             int(r.integers(1 << 30)))
    return b.arrays(), {}


def over_ten_case():
    """Reads with 11-24 kept species of distinct, partly equal scores."""
    r = np.random.default_rng(5)
    b = Reads()
    for k in (11, 13, 17, 24):
        rid = b.read(400)
        for i, sp in enumerate(r.permutation(SPECIES)[:k]):
            n = 4 + int(r.integers(0, 6))
            b.chain(rid, int(sp), i % 3, 3 * int(r.integers(0, 80)) + i % 3,
                    r.integers(0, 4, size=n - 1).tolist(), seed=10 * rid + i)
    return b.arrays(), {}


def equal_scores_case():
    """Species of identical chains (exactly equal scores): a tie of 3,
    12 equal species (the top-10 cut among equals, in run order), and
    equal runner-ups below a best."""
    b = Reads()
    rid = b.read(200)
    for i, sp in enumerate(SPECIES[2:5]):
        b.chain(rid, sp, 0, 30, [0, 0, 1, 2], seed=i)
    rid = b.read(200)
    for i, sp in enumerate(SPECIES[:12]):
        b.chain(rid, sp, 1, 31, [0, 3, 3, 0, 1], seed=40 + i)
    rid = b.read(300)
    b.chain(rid, SPECIES[20], 2, 2, [0] * 12, seed=7)
    for i, sp in enumerate(SPECIES[5:9]):
        b.chain(rid, sp, 2, 50, [0, 0, 0], seed=60 + i)
    return b.arrays(), {}


def tie_edge_qlens(side):
    """Query lengths at which a species of path score 38 lies exactly on
    the f32-rounded tie threshold of one of score 40 (tie_ratio 0.95):
    f32(f64(best) * 0.95) == its score, with the f64 threshold above
    ('above': outside the f64 tie set) or below it ('below': inside)."""
    f = np.float32
    out = []
    for q in range(41, 4000):
        b, t = f(40) / f(q), f(38) / f(q)
        thr = float(b) * 0.95
        if f(thr) == t and (thr > float(t)) == (side == "above") \
                and thr != float(t):
            out.append(q)
    return out[:6]


def tie_edge_case(side):
    # path scores: 24 (rh0 = 0) + increments; 40 = 24 + 5*3 + 1.0,
    # 38 = 24 + 4*3 + 2*1.0
    b = Reads()
    for i, q in enumerate(tie_edge_qlens(side)):
        rid = b.read(q)
        best, edge = SPECIES[i], SPECIES[i + 9]
        b.chain(rid, best, 0, 30, [0, 0, 0, 0, 0, 2], seed=i)
        b.chain(rid, edge, 1, 31, [0, 0, 0, 0, 2, 2], seed=20 + i)
        if i % 2:   # a third, untied species after them
            b.chain(rid, SPECIES[-1], 2, 32, [3, 3, 3], seed=40 + i)
    return b.arrays(), dict(min_score=0.0, min_sp_score=0.0)


def tie_sums_case():
    """Five tied species of distinct scores (path scores 38.5-40.5,
    clear of the tie edge), in run order the reverse of the score order,
    at query lengths where their f32 sum depends on the order of the
    adds."""
    incs = ([0, 0, 0, 0, 1, 2], [0, 0, 0, 0, 0], [0, 0, 0, 0, 1, 2, 2],
            [0, 0, 0, 0, 0, 2], [0, 0, 0, 0, 0, 1])   # 38.5 .. 40.5
    b = Reads()
    for i, q in enumerate((41, 43, 47, 53, 59, 61, 67, 71)):
        rid = b.read(q)
        for j, inc in enumerate(incs):
            b.chain(rid, SPECIES[j + 5 * (i % 3)], j % 3, 3 * j + j % 3,
                    inc, seed=10 * i + j)
    return b.arrays(), dict(min_score=0.0, min_sp_score=0.0)


def many_paths_case():
    """Multi-path species runs: disjoint and overlapping chains (the
    combine's trims), runs of 2-12 paths and one of 40 paths."""
    r = np.random.default_rng(11)
    b = Reads()
    for n_paths in (2, 5, 12, 40):
        rid = b.read(3 * 45 * n_paths + 150)
        for j in range(n_paths):
            gap = 45 if j % 3 else 36   # some paths overlap the previous
            b.chain(rid, SPECIES[0], 0, j * gap,
                    r.integers(0, 4, size=4).tolist(), seed=100 * n_paths + j)
        for j in range(3):
            b.chain(rid, SPECIES[1], j % 3, 90 * j + j % 3,
                    r.integers(0, 3, size=5).tolist(), seed=7 * n_paths + j)
    return b.arrays(), dict(min_score=0.0)


def under_min_score_case():
    """Reads whose every species falls under min_score (long queries),
    beside reads with one species above it."""
    b = Reads()
    for i in range(4):
        rid = b.read(5000)
        for j, sp in enumerate(SPECIES[i:i + 3]):
            b.chain(rid, sp, j % 3, 9 * j + j % 3, [0, 1, 2, 3], seed=10 * i + j)
        rid = b.read(150)
        b.chain(rid, SPECIES[5 + i], 0, 0, [0] * 8, seed=99 + i)
        b.chain(rid, SPECIES[12 + i], 1, 10, [1, 3, 3], seed=77 + i)
    return b.arrays(), dict(min_score=0.15)


def empty_case():
    """Reads with no matches, with matches but no path (chains shorter
    than min_cons_cnt, lone matches, reverse frames that never chain),
    reads with paths between them, and pad reads at the end."""
    b = Reads()
    b.read(150)                                    # no matches
    rid = b.read(150)
    b.chain(rid, SPECIES[0], 0, 0, [0, 0], seed=1)      # depth 3 < 4
    b.single(rid, SPECIES[1], 1, 31, seed=2)
    rid = b.read(150)
    b.chain(rid, SPECIES[2], 0, 30, [0, 0, 0, 1], seed=3)
    b.chain(rid, SPECIES[3], 4, 31, [0, 0], seed=4)
    b.read(150)                                    # no matches
    rid = b.read(150)
    b.chain(rid, SPECIES[4], 2, 2, [0, 1, 0, 1, 0], seed=5)
    return b.arrays(n_pad=3), {}


CASES = {f"seed{s}": (lambda s=s: random_case(s)) for s in range(6)}
CASES.update({
    "over_ten": over_ten_case,
    "equal_scores": equal_scores_case,
    "tie_edge_below": lambda: tie_edge_case("below"),
    "tie_edge_above": lambda: tie_edge_case("above"),
    "tie_sums": tie_sums_case,
    "many_paths": many_paths_case,
    "under_min_score": under_min_score_case,
    "empty_and_pad": empty_case,
})
NUMPY_COMBINE = {"many_paths"}   # also run without the C++ combine

# The plain (non-EM) pass rounds the tie threshold to f32
# (`_score_paths_vec`'s `thr`); the scalar oracle compares in f64.  A
# score that equals the rounded threshold but lies under the f64 one is
# tied there and not here.
PLAIN_TIE_EDGE = pytest.mark.xfail(
    strict=True, reason="the plain pass ties a score on the f32-rounded "
    "threshold that the scalar f64 comparison leaves out")


def _params():
    out = []
    for name in CASES:
        for em in (False, True):
            for native in ((True, False) if name in NUMPY_COMBINE else (True,)):
                marks = (PLAIN_TIE_EDGE,) if (name == "tie_edge_above"
                                              and not em) else ()
                tag = f"{name}-{'em' if em else 'plain'}" + (
                    "" if native else "-numpy_combine")
                out.append(pytest.param(name, em, native, id=tag, marks=marks))
    return out


def compare_results(a, b, i):
    assert a.is_classified == b.is_classified, f"read {i}: classified"
    assert a.classification == b.classification, f"read {i}: taxid"
    assert a.score == b.score, f"read {i}: score {a.score} vs {b.score}"
    assert a.tax_cnt == b.tax_cnt, f"read {i}: tax_cnt"
    assert a.top_species == b.top_species, f"read {i}: top_species"
    assert a.species_scores == b.species_scores, f"read {i}: species_scores"
    assert type(a.species_scores) is type(b.species_scores), f"read {i}"


@pytest.mark.parametrize("case,em,native", _params())
def test_vec_equals_scalar(case, em, native, monkeypatch):
    if not native:
        monkeypatch.setattr(taxonomer_vec, "_NATIVE_COMBINE", False)
    (m, qlens), kw = CASES[case]()
    tax = make_tax()
    kwargs = dict(kmer_format=2, seq_mode=1, min_score=0.05,
                  min_sp_score=0.3, em=em)
    kwargs.update(kw)
    scalar = Taxonomer(tax, **kwargs)
    vec = VectorTaxonomer(tax, **kwargs)

    n_reads = len(qlens) - 1
    bounds = np.searchsorted(m["qid"].astype(np.int64),
                             np.arange(1, n_reads + 2))
    want = [scalar.classify_read(m[bounds[i]:bounds[i + 1]], int(qlens[i + 1]))
            if bounds[i + 1] > bounds[i] else ReadResult()
            for i in range(n_reads)]
    got = vec.classify_batch(m, qlens, n_reads)
    for i in range(n_reads):
        compare_results(want[i], got[i], i)

    listed = sum(bool(r.species_scores) for r in got)
    assert vec.species_list_reads == (listed if em else 0)
    if em:
        assert listed > 0
    if case == "over_ten" and em:
        assert all(len(r.species_scores) == 10 for r in got)
    if case == "many_paths":     # a run beyond the numpy combine's 32
        pa = vec._dp_paths(m)
        key = pa["qid"] * (1 << 32) + pa["species"]
        assert np.unique(key, return_counts=True)[1].max() > 32
