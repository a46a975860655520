"""One timed pass of an EM cell against the plain EM reference.

    python -m portbench.em_compare --workload gtdb40.em-paired150 \
        --seed <n> [--queries N] [--procs 8]

On the card (`--device cpu` for the CPU), from the root of a checkout.
It draws the cell's timed sample from --seed as a run does (stream 2;
--queries N draws N queries instead of the mix's `sample_queries`),
runs one pass of the cell's entry on it (Classifier.classify_file,
then classify/em.run_em), frees the program's state, and computes the
same pass with the plain reference: each query's answer and mappings
from the reference's matcher and scorer (reference/em.py's listing
scorer; --procs processes), the species' unique k-mers from the
reference's own index, the EM and the reclassification of
reference/em.py.  It prints each comparison beside its tolerance and
exits 1 when one is outside it.  The benchmark's own runs never run it.

Tolerances (TOLERANCES), and why:
- answers and mapping lists: exact.  The per-read answers are what the
  run's check compares; each mapping is the scorer's float32 species
  score, squared and stored as float32, on both sides.
- unique k-mer counts a species: exact (both count one entry a
  distinct (metamer, species)).
- reads mapped and EM iterations: mapped exact; iterations within 1
  (the program sums the probabilities' change pairwise, the reference
  in species order, so a change at 1e-6 may stop one a step apart).
- EM report counts: exact, except a species whose probability x mapped
  reads lies within 1e-6 of a half (the rounding's edge); the
  unclassified count follows.
- reclassification: each read's taxon exact, except where the
  reference's posterior before or after the set's last species lies
  within 1e-6 of 0.5 (the program takes a read's posteriors as
  differences of one cumulative sum over the whole sample, the
  reference sums the read's own); each score within 5e-4 of the
  reference's, relative (the results file prints 4 significant
  digits), plus 1e-9.
"""

import argparse
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from portbench import catalog, check
from portbench import run as bench_run
from portbench.reference import em as em_ref

JOB = "em"
# a reading's limit (0 where not named), and the edges and score bounds
# the readings are taken with
TOLERANCES = {"iterations": 1, "report_edge": 1e-6, "posterior_edge": 1e-6,
              "score_rel": 5e-4, "score_abs": 1e-9}

_REF = {}


def program_pass(cfg, traffic, seed, n_queries, device, cache, out_dir):
    """One pass of the program on the cell's sample: (sample, run_em's
    return, each query's answer, the database directory)."""
    import torch

    from metabuli_work_tpu_torch.classify.em import run_em
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)

    bench_run.pin_environment(cache, traffic)
    genomes, tax = bench_run.load_genomes(cfg, cache)
    db_dir, _ = bench_run.program_db(cfg, genomes, tax, cache)
    params = ClassifyParams(seq_mode=traffic["seq_mode"],
                            min_score=traffic["min_score"],
                            min_sp_score=traffic["min_sp_score"],
                            batch_size=traffic["batch"],
                            **traffic.get("params", {}))
    run = bench_run.Run(cfg, traffic, seed, 0, False, device, out_dir)
    gen = catalog.generator(traffic["kind"])
    sample = gen.draw(genomes, traffic, n_queries, run.rng(2))
    p1 = os.path.join(out_dir, "sample_1.fna")
    p2 = os.path.join(out_dir, "sample_2.fna")
    gen.write_fasta(sample, p1, p2)
    clf = Classifier(db_dir, params, device=device)
    results = clf.classify_file(p1, p2 if sample.seqs2 is not None else None)
    st = run_em(results, clf, out_dir, JOB)
    answers = [check.answer(r.result) for r in results]
    del clf, results
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return sample, st, answers, db_dir


def _classify_chunk(idx):
    ref, sample = _REF["ref"], _REF["sample"]
    out = []
    for i in idx:
        res = ref.classify(sample.mate(i, 1), sample.mate(i, 2))
        out.append((check.answer(res), em_ref.mappings(ref)))
    return out


def reference_pass(ref, sample, procs):
    """Each query's (answer, mappings) by the listing reference, in
    `procs` forked processes."""
    _REF.update(ref=em_ref.listing(ref), sample=sample)
    chunks = np.array_split(np.arange(len(sample)), max(procs, 1) * 8)
    chunks = [c.tolist() for c in chunks if len(c)]
    if procs <= 1:
        parts = [_classify_chunk(c) for c in chunks]
    else:
        with multiprocessing.get_context("fork").Pool(procs) as pool:
            parts = pool.map(_classify_chunk, chunks)
    return [x for p in parts for x in p]


def program_mappings(out_dir, n):
    """The program's mapping file as a list a query of (species,
    score^2)."""
    arr = np.fromfile(os.path.join(out_dir, f"{JOB}_mapping_results.txt"),
                      dtype=np.dtype([("q", "<u4"), ("s", "<i4"),
                                      ("v", "<f4")]))
    out = [[] for _ in range(n)]
    for q, s, v in zip(arr["q"].tolist(), arr["s"].tolist(),
                       arr["v"].astype(np.float64).tolist()):
        out[q].append((s, v))
    return out


def report_taxon_counts(path):
    """{original taxid: taxon_count} of a Kraken-style report."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if int(parts[2]):
                out[int(parts[4])] = int(parts[2])
    return out


def results_rows(path):
    """[(original taxid, score)] a query of an EM+reclassify results
    file (taxid 0 for a read left unclassified)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            rows.append((int(parts[2]), float(parts[4])))
    return rows


def kmer_counts_file(db_dir):
    out = {}
    with open(os.path.join(db_dir, "sp2uniqKmerCnt")) as f:
        for line in f:
            t, c = line.split()
            out[int(t)] = int(c)
    return out


def compare(sample, st, answers, out_dir, db_dir, ref_out, counts, taxonomy,
            orig):
    """({name: (reading, limit, within)} of each comparison, a summary
    of the pass)."""
    n = len(sample)
    lists = [m for _, m in ref_out]
    got_lists = program_mappings(out_dir, n)
    prob, mapped, iters = em_ref.estimate(lists, counts)
    out = {}
    out["answers"] = sum(a != r for a, (r, _) in zip(answers, ref_out))
    out["mappings"] = sum(a != b for a, b in zip(got_lists, lists))
    got_counts = kmer_counts_file(db_dir)
    used = {s for m in lists for s, _ in m}
    out["kmer_counts"] = sum(got_counts.get(s) != counts.get(s)
                             for s in used)
    out["mapped"] = abs(st["mapped"] - mapped)
    out["iterations"] = abs(st["iterations"] - iters)
    # EM report
    want = em_ref.report_counts(prob, mapped, n)
    got = report_taxon_counts(os.path.join(out_dir, f"{JOB}_EM_report.tsv"))
    edge = {orig[s] for s, p in prob.items()
            if abs(p * mapped % 1.0 - 0.5) < TOLERANCES["report_edge"]}
    want = {orig[s]: c for s, c in want.items()}
    # the rounded counts may sum above the reads; the report then has no
    # unclassified line
    want[0] = max(want[0], 0)
    bad = 0
    for t in set(got) | set(want):
        if got.get(t, 0) != want.get(t, 0) \
                and not (t in edge or (t == 0 and edge)):
            bad += 1
    out["report_counts"] = bad
    # reclassification
    rows = results_rows(os.path.join(out_dir,
                                     f"{JOB}_EM+reclassify_results.tsv"))
    recl = em_ref.reclassify(lists, prob, counts, taxonomy)
    taxa = near = 0
    worst = 0.0
    for (t, sc), r in zip(rows, recl):
        rt, rs, margin = (0, 0.0, 1.0) if r is None else \
            (orig[r[0]], r[1], r[2])
        if t != rt:
            if margin < TOLERANCES["posterior_edge"]:
                near += 1
            else:
                taxa += 1
            continue
        worst = max(worst, abs(sc - rs) - TOLERANCES["score_abs"]
                    - TOLERANCES["score_rel"] * abs(rs))
    out["reclassified_taxa"] = taxa
    out["reclassified_at_edge"] = near
    out["score_excess"] = max(worst, 0.0)
    out["rows"] = abs(len(rows) - n)
    lim = {k: TOLERANCES.get(k, 0) for k in out}
    lim.update(reclassified_at_edge=None, score_excess=0.0)
    res = {k: (v, lim[k], lim[k] is None or v <= lim[k])
           for k, v in out.items()}
    summary = {"queries": n, "mapped": mapped, "iterations": iters,
               "species": len(prob), "program": st,
               "reclassified_above_species": sum(
                   1 for r in recl if r is not None
                   and taxonomy.ranks[r[0]] != "species")}
    return res, summary


def em_compare(cfg, traffic, seed, n_queries, device, cache, procs):
    """Runs both passes; returns (compare()'s readings and summary,
    seconds of the program's pass, seconds of the reference's)."""
    out_dir = tempfile.mkdtemp(prefix="portbench_em_")
    try:
        t0 = time.perf_counter()
        sample, st, answers, db_dir = program_pass(
            cfg, traffic, seed, n_queries, device, cache, out_dir)
        t_prog = time.perf_counter() - t0
        t0 = time.perf_counter()
        genomes, tax = bench_run.load_genomes(cfg, cache)
        parent, ranks, _, orig, species = tax
        values, sp = check.reference_index(cfg, genomes, species,
                                           bench_run.ref_cache(cache, cfg))
        ref = check.make_reference(cfg, traffic, values, sp, parent, ranks)
        ref_out = reference_pass(ref, sample, procs)
        counts = em_ref.unique_kmer_counts(sp)
        got = compare(sample, st, answers, out_dir, db_dir, ref_out, counts,
                      ref.scorer.taxonomy, orig)
        return got, t_prog, time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--procs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = catalog.cell(catalog.benchmark(), args.workload)
    cfg = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    (res, summary), t_prog, t_ref = em_compare(
        cfg, traffic, args.seed, args.queries or traffic["sample_queries"],
        args.device, bench_run.cache_root(), args.procs)
    tag = f"em_compare {args.workload} seed {args.seed}:"
    for name, (v, lim, _) in res.items():
        print(f"{tag} {name} {v}"
              + ("" if lim is None else f" (tolerance {lim})"))
    print(f"{tag} summary {summary}")
    ok = all(within for _, _, within in res.values())
    print(f"{tag} program pass {t_prog:.1f} s, reference {t_ref:.1f} s; "
          f"{'within' if ok else 'OUTSIDE'} every tolerance")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
