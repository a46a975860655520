"""The configurations' genomes (databases/clades.py): fixed by the
file's db_seed, a tree of families, genera and species, and species and
genera as far apart as the configuration states."""

import numpy as np

from portbench import catalog
from portbench.databases import clades

from .conftest import tiny_config


def _cfg(**over):
    return dict(tiny_config(((3, 1), (1,))), genome_len=120_000, **over)


def test_same_db_seed_same_genomes():
    assert np.array_equal(clades.genomes(_cfg()), clades.genomes(_cfg()))
    assert not np.array_equal(clades.genomes(_cfg()),
                              clades.genomes(_cfg(db_seed=1)))


def test_taxonomy_is_families_genera_species():
    parent, ranks, names, orig, species = clades.taxonomy(_cfg())
    assert ranks[2:4] == ["family"] * 2
    assert ranks[4:7] == ["genus"] * 3
    assert [ranks[s] for s in species] == ["species"] * 5
    # species 0-2 in genus G1, 3 in G2 (both under F1), 4 in G3 under F2
    assert [parent[s] for s in species] == [4, 4, 4, 5, 6]
    assert parent[4:7] == [2, 2, 3]
    assert len(set(orig)) == len(orig) == len(names)


def test_divergences_as_configured():
    """Two species of a genus differ by about twice the species
    divergence, two genera of a family by about twice both; proteins
    stay closer than the DNA where the third codon base changes more."""
    cfg = _cfg()
    G = clades.genomes(cfg)
    same_genus = (G[0] != G[1]).mean()
    other_genus = (G[0] != G[3]).mean()
    other_family = (G[0] != G[4]).mean()
    ds, dg = cfg["species_divergence"], cfg["genus_divergence"]
    w = cfg["third_position_weight"]
    # a base changes with probability d * weight in each lineage, the
    # weights 3w/(w+2) on a third codon base and 3/(w+2) elsewhere
    rates = np.array([1, 1, w]) * 3 / (w + 2)

    def apart(d):
        p = d * rates
        return float(np.mean(2 * p - 4 / 3 * p * p))
    assert abs(same_genus - apart(ds)) < 0.01
    assert apart(ds) < other_genus < 2 * (ds + dg)
    assert abs(other_family - 0.75) < 0.01


def test_third_codon_base_changes_most():
    cfg = _cfg(gene_len=1002)
    w = clades.codon_weights(cfg, np.random.default_rng(0))
    assert abs(w.mean() - 1) < 1e-9
    lo, hi = w.min(), w.max()
    assert np.isclose(hi, cfg["third_position_weight"] * lo)
    assert set(np.unique(w)) == {lo, hi}
    assert abs((w == hi).mean() - 1 / 3) < 0.01


def test_benchmark_configs_are_clades():
    for c in catalog.benchmark()["configs"]:
        cfg = catalog.config(c["name"])
        assert cfg["kind"] == "clades" and cfg["name"] == c["name"]
        fam_of, gen_of = clades.tree(cfg)
        assert len(gen_of) == sum(map(sum, cfg["families"]))
