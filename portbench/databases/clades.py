"""Genomes of a configuration of kind "clades": a tree of families,
genera and species made from the file's `db_seed` (never from a run's
--seed: a lab's database stays fixed while its samples change).

- `families`: one list a family, of species counts a genus;
- each family is a random ancestor of `genome_len` bases, cut into
  genes of `gene_len` bases on a strand drawn for each gene;
- each genus is its family's ancestor with a `genus_divergence` share
  of its bases changed, each species its genus's with a
  `species_divergence` share changed;
- a change lands on the third base of a codon (of its gene's frame and
  strand) `third_position_weight` times as often as on the first or
  second, so proteins stay closer than the DNA, as in real genomes.

A changed base always becomes another base.  Species follow each other
family by family, genus by genus.

Taxonomy, in the program's internal ids: 1 the root, then the families,
then the genera, then the species, each genome a species of its own.
"""

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
CODE = np.zeros(256, dtype=np.uint8)
CODE[ACGT] = np.arange(4, dtype=np.uint8)


def tree(config):
    """(family of each genus, genus of each species)."""
    fam_of, gen_of = [], []
    for f, genera in enumerate(config["families"]):
        for n_sp in genera:
            gen_of += [len(fam_of)] * n_sp
            fam_of.append(f)
    return fam_of, gen_of


def taxonomy(config):
    """(parent, ranks, names, original ids) over internal ids, and the
    species id of each genome."""
    fam_of, gen_of = tree(config)
    n_f, n_g, n_s = len(config["families"]), len(fam_of), len(gen_of)
    g0, s0 = 2 + n_f, 2 + n_f + n_g
    parent = [0, 1] + [1] * n_f + [2 + f for f in fam_of] \
        + [g0 + g for g in gen_of]
    ranks = ["no rank", "no rank"] + ["family"] * n_f + ["genus"] * n_g \
        + ["species"] * n_s
    names = (["unclassified", "root"] + [f"F{i + 1}" for i in range(n_f)]
             + [f"G{i + 1}" for i in range(n_g)]
             + [f"Species{i}" for i in range(n_s)])
    orig = [0, 1] + [11 + i for i in range(n_f)] \
        + [101 + i for i in range(n_g)] + [1000 + i for i in range(n_s)]
    return parent, ranks, names, orig, [s0 + i for i in range(n_s)]


def codon_weights(config, rng):
    """Per base, the relative rate of change: third_position_weight on
    the third base of a codon of its gene, 1 elsewhere; mean 1."""
    L, n = config["genome_len"], config["gene_len"]
    pos = np.arange(L)
    start = pos - pos % n
    end = np.minimum(start + n, L)
    reverse = rng.random(-(-L // n)) < 0.5
    phase = np.where(reverse[pos // n], end - 1 - pos, pos - start) % 3
    w = np.where(phase == 2, float(config["third_position_weight"]), 1.0)
    return w / w.mean()


def diverge(seq, share, weights, rng):
    """seq with about `share` of its bases changed, base i with a
    probability share * weights[i], each to one of the other three."""
    out = seq.copy()
    hit = np.flatnonzero(rng.random(len(seq)) < share * weights)
    shift = rng.integers(1, 4, size=len(hit)).astype(np.uint8)
    out[hit] = ACGT[(CODE[seq[hit]] + shift) % 4]
    return out


def genomes(config):
    """[n, genome_len] uint8 rows of ACGT, one a species."""
    fam_of, gen_of = tree(config)
    rng = np.random.default_rng(config["db_seed"])
    L = config["genome_len"]
    fams = []
    for _ in config["families"]:
        fams.append((ACGT[rng.integers(0, 4, size=L)],
                     codon_weights(config, rng)))
    genera = [(diverge(fams[f][0], config["genus_divergence"], fams[f][1],
                       rng), fams[f][1]) for f in fam_of]
    out = np.empty((len(gen_of), L), dtype=np.uint8)
    for i, g in enumerate(gen_of):
        seq, w = genera[g]
        out[i] = diverge(seq, config["species_divergence"], w, rng)
    return out
