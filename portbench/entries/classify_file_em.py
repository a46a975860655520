"""Timed entry "classify_file_em": a lab's `classify --em` on one sample
after another.  A pass is Classifier.classify_file on the sample's
files, then the program's EM pass, classify/em.run_em(results,
classifier, <run's tmpdir>, job), as the CLI runs it; the pass ends
when the EM files are written.  The sample, the checked queries and
the window are as in entries/classify_file.py: the checked answers are
the per-read results of classify_file, and of each pass only those and
run_em's return (kept in the window's "em") stay; the traced slice
covers classification only (window()).  The warm-up runs the
same passes on a sample of its own, so the species' unique k-mer
counts the EM pass caches in the database directory are made in
set-up."""

import os
import time

from metabuli_work_tpu_torch.classify.em import run_em
from portbench import catalog, check

plain = catalog.entry("classify_file")

WARMUP_PASSES = 2
JOB = "sample"


def _out_dir(run):
    d = os.path.join(run.tmpdir, "em")
    os.makedirs(d, exist_ok=True)
    return d


def warm(run):
    """Warm-up passes (classify_file, then run_em) on the warm-up sample
    (stream 1 of the seed); returns queries/s of the last pass."""
    t = run.traffic
    n = t["warmup_batches"] * t["batch"]
    sample = run.gen.draw(run.genomes, t, n, run.rng(1))
    p1, p2 = plain._files(run, "warm", sample)
    out = _out_dir(run)
    rate = 0.0
    for _ in range(WARMUP_PASSES):
        t0 = time.perf_counter()
        results = run.clf.classify_file(p1, p2)
        run_em(results, run.clf, out, JOB)
        rate = n / (time.perf_counter() - t0)
    os.unlink(p1)
    if p2:
        os.unlink(p2)
    return rate


prepare = plain.prepare


def window(run, state):
    """As classify_file's window, each pass followed by run_em.  The
    traced slice starts at the first batch of a pass (the first after
    its start time) and stops before the pass's EM if it is still on:
    it holds classification only, whose per-batch device metrics a
    slice across the EM pass and the pipeline's drain and fill would
    skew."""
    p1, p2 = state["files"]
    checked = state["checked"]
    out = _out_dir(run)
    done_at, answers, em = [], [], []
    sent = queries = 0
    sl = run.slice

    def progress(done):
        done_at.append(time.perf_counter())
        if sl is not None and (sl.active or (sl.t_start is None
                                             and done <= run.traffic["batch"])):
            sl.poll()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        results = run.clf.classify_file(p1, p2, progress=progress)
        if sl is not None:
            sl.stop()
        em.append(run_em(results, run.clf, out, JOB))
        t1 = time.perf_counter()
        sent += len(state["sample"])
        queries += sum(r is not None for r in results)
        answers += [(i, None if results[i] is None
                     else check.answer(results[i].result)) for i in checked]
        del results
        if t1 >= deadline:
            break
    return {"t0": t0, "t1": t1, "sent": sent, "queries": queries,
            "answers": answers, "batch_ends": done_at, "calls": [],
            "em": em}
