"""classify --em against the benchmark's plain references, on the CPU.

Tiny configurations of the benchmark's `clades` kind (seeded genomes of
50 kb, gtdb40-em's settings otherwise), each a sample of paired reads
drawn as the cell gtdb40.em-paired150 draws them:

- the port's per-read answers under --em equal its answers without it
  and the plain reference's (portbench/reference/classify.py), which is
  what lets the cell's unchanged check hold it;
- run_em's mapping file, EM report and reclassified rows equal the
  plain EM reference's (portbench/reference/em.py) within the
  tolerances written below;
- on a genus of near-identical species, EM reassigns some reads to
  the genus, on both sides.
"""

import pytest

from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from portbench import catalog, check, em_compare
from portbench import run as bench_run
from portbench.reference import em as em_ref
from portbench.reference.taxonomy import Taxonomy

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

SEED = 2 ** 31 + 21
QUERIES = 300
# species_divergence: gtdb40's 10% (a read maps about one species), and
# 1% (a genus of near-identical species: reads map all of them)
CASES = {"gtdb40": 0.1, "one-genus": 0.01}

# Tolerances of the EM output against the reference, as the chip's
# comparison (portbench/em_compare.py) takes them: answers, mapping lists,
# unique k-mer counts, mapped reads and the report's counts exact (no
# species of these samples lies within 1e-6 of a rounding edge); the EM's
# iterations within 1 (the program sums the probabilities' change
# pairwise, the reference in order); each reclassified taxon exact where
# the reference's posterior around the cut lies 1e-6 or more from 0.5;
# each reclassified score within 5e-4 relative (4 significant digits in
# the results file) plus 1e-9.
ITERATIONS = 1
POSTERIOR_EDGE = 1e-6
SCORE_REL, SCORE_ABS = 5e-4, 1e-9


def _config(divergence):
    return dict(catalog.config("gtdb40-em"), families=[[3, 1], [2]],
                genome_len=50_000, species_divergence=divergence,
                name=f"tinyem-{divergence}")


def _traffic():
    return dict(catalog.traffic("em-paired150"), batch=64,
                warmup_batches=2, check_reads=40)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The port's pass under --em (classify_file, then run_em), its
    answers without --em on the same files, and the references' pass."""
    root = tmp_path_factory.mktemp(f"em_{request.param}")
    cfg, traffic = _config(CASES[request.param]), _traffic()
    cache = bench_run.cache_root(str(root))
    out = root / "out"
    out.mkdir()
    sample, st, answers, db_dir = em_compare.program_pass(
        cfg, traffic, SEED, QUERIES, "cpu", cache, str(out))
    plain = Classifier(db_dir, ClassifyParams(
        seq_mode=traffic["seq_mode"], min_score=traffic["min_score"],
        min_sp_score=traffic["min_sp_score"], batch_size=traffic["batch"]),
        device="cpu")
    got_plain = [check.answer(r.result) for r in plain.classify_file(
        str(out / "sample_1.fna"), str(out / "sample_2.fna"))]
    genomes, tax = bench_run.load_genomes(cfg, cache)
    parent, ranks, _, orig, species = tax
    values, sp = check.reference_index(cfg, genomes, species,
                                       bench_run.ref_cache(cache, cfg))
    ref = check.make_reference(cfg, traffic, values, sp, parent, ranks)
    ref_out = em_compare.reference_pass(ref, sample, 1)
    counts = em_ref.unique_kmer_counts(sp)
    readings, summary = em_compare.compare(
        sample, st, answers, str(out), db_dir, ref_out, counts,
        ref.scorer.taxonomy, orig)
    return dict(name=request.param, answers=answers, plain=got_plain,
                ref=[a for a, _ in ref_out], lists=[m for _, m in ref_out],
                readings=readings, summary=summary)


def test_answers_under_em_equal_plain_and_reference(case):
    assert len(case["answers"]) == QUERIES
    assert case["answers"] == case["plain"]
    assert case["answers"] == case["ref"]
    assert sum(a[0] for a in case["answers"]) >= QUERIES * 0.9


def test_em_output_equals_reference(case):
    r = {k: v[0] for k, v in case["readings"].items()}
    assert r["mappings"] == 0 and r["kmer_counts"] == 0
    assert r["mapped"] == 0 and r["iterations"] <= ITERATIONS
    assert r["report_counts"] == 0 and r["rows"] == 0
    assert r["reclassified_taxa"] == 0
    assert r["score_excess"] == 0.0
    assert all(within for _, _, within in case["readings"].values())
    tol = em_compare.TOLERANCES
    assert (tol["iterations"], tol["posterior_edge"], tol["score_rel"],
            tol["score_abs"]) == (ITERATIONS, POSTERIOR_EDGE, SCORE_REL,
                                  SCORE_ABS)
    summary = case["summary"]
    assert summary["program"]["mappings"] == sum(map(len, case["lists"]))
    assert summary["mapped"] == summary["program"]["mapped"] > 0


def test_one_genus_reads_go_to_the_genus(case):
    """Reads of a genus of near-identical species map several of them;
    EM leaves some with no species at 0.5 posterior, and both sides
    reassign them to the genus.  At gtdb40's divergence a read maps
    about one species."""
    summary = case["summary"]
    several = sum(len(m) > 1 for m in case["lists"])
    if case["name"] == "one-genus":
        assert several > QUERIES // 2
        assert summary["reclassified_above_species"] > 0
        assert case["readings"]["reclassified_taxa"][0] == 0
    else:
        assert several < QUERIES // 10


def test_reference_em_by_hand():
    """reference/em.py on two reads worked by hand: species 5 and 6 of
    genus 3 with equal unique k-mers; read 0 maps only 5, read 1 both
    (squared scores 0.81 and 0.64)."""
    tax = Taxonomy([0, 1, 1, 2, 2, 3, 3], ["no rank", "no rank", "family",
                                           "genus", "genus", "species",
                                           "species"])
    counts = {5: 100, 6: 100}
    reads = [[(5, 0.81)], [(5, 0.81), (6, 0.64)], []]
    prob, mapped, iters = em_ref.estimate(reads, counts, max_iter=1)
    # one step from (1/2, 1/2): read 0 gives 5 all of it, read 1 splits
    # 0.81 : 0.64
    assert mapped == 2 and iters == 1
    assert prob[5] == pytest.approx((1 + 0.81 / 1.45) / 2)
    assert prob[6] == pytest.approx((0.64 / 1.45) / 2)
    prob, mapped, iters = em_ref.estimate(reads, counts)
    assert prob[5] > 0.999 and 1 < iters < em_ref.MAX_ITER
    assert em_ref.report_counts(prob, mapped, 3) == {5: 2, 0: 1}
    # with the probabilities even, read 1's first species holds 0.56 of
    # it: the read keeps species 5; at 6 twice as likely, 6 comes first
    # with 0.61 and the read keeps 6
    even = em_ref.reclassify(reads, {5: 0.5, 6: 0.5}, counts, tax)
    assert even[0][0] == 5 and even[2] is None
    assert even[1][0] == 5 and even[1][1] == pytest.approx(0.81 / 1.45)
    skew = em_ref.reclassify(reads, {5: 1 / 3, 6: 2 / 3}, counts, tax)
    assert skew[1][0] == 6
    assert skew[1][1] == pytest.approx(1.28 / (1.28 + 0.81))
    # a species with one unique k-mer weighs nothing (1/log 1)
    flat = em_ref.reclassify([[(5, 0.5), (6, 0.5)]], {5: 0.5, 6: 0.5},
                             {5: 100, 6: 1}, tax)
    assert flat[0][0] == 5 and flat[0][1] == 1.0
    # three equal species: the first two reach 2/3 and their LCA is the
    # genus
    tax3 = Taxonomy([0, 1, 1, 2, 3, 3, 3], ["no rank", "no rank", "family",
                                            "genus", "species", "species",
                                            "species"])
    three = em_ref.reclassify([[(4, 0.5), (5, 0.5), (6, 0.5)]],
                              {4: 1 / 3, 5: 1 / 3, 6: 1 / 3},
                              {4: 50, 5: 50, 6: 50}, tax3)
    assert three[0][0] == 3 and three[0][1] == pytest.approx(2 / 3)
    assert three[0][2] == pytest.approx(1 / 6)
