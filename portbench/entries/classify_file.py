"""Timed entry "classify_file": one sample of reads as FASTA files (a
pair of files under --seq-mode 2) through Classifier.classify_file, as
a lab classifies a sample, one sample after another.  The sample holds
the mix's `sample_queries` queries, drawn from the seed (stream 2), so
every seed gives the same amount of work; the window calls
classify_file on it again and again until --seconds have passed, and
ends when the call under way returns, every result on the host.  Of
each call's records only the answers the check compares are kept."""

import os
import time

from portbench import check

WARMUP_PASSES = 2


def _files(run, tag, sample):
    p1 = os.path.join(run.tmpdir, f"{tag}_1.fna")
    p2 = os.path.join(run.tmpdir, f"{tag}_2.fna")
    run.gen.write_fasta(sample, p1, p2)
    return p1, (p2 if sample.seqs2 is not None else None)


def warm(run):
    """Warm-up passes on a sample of its own (stream 1 of the seed):
    the first settles the retry ladder's knobs and builds what is built
    at first use; returns queries/s of the last pass."""
    t = run.traffic
    n = t["warmup_batches"] * t["batch"]
    sample = run.gen.draw(run.genomes, t, n, run.rng(1))
    p1, p2 = _files(run, "warm", sample)
    rate = 0.0
    for _ in range(WARMUP_PASSES):
        t0 = time.perf_counter()
        run.clf.classify_file(p1, p2)
        rate = n / (time.perf_counter() - t0)
    os.unlink(p1)
    if p2:
        os.unlink(p2)
    return rate


def prepare(run):
    """The timed sample (stream 2 of the seed), its files and the
    queries the check compares (stream 3)."""
    sample = run.gen.draw(run.genomes, run.traffic,
                          run.traffic["sample_queries"], run.rng(2))
    return {"sample": sample, "files": _files(run, "sample", sample),
            "checked": check.pick(sample, run.traffic["check_reads"],
                                  run.rng(3))}


def window(run, state):
    p1, p2 = state["files"]
    checked = state["checked"]
    done_at, answers = [], []
    sent = queries = 0

    def progress(_done):
        done_at.append(time.perf_counter())
        if run.slice is not None:
            run.slice.poll()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        results = run.clf.classify_file(p1, p2, progress=progress)
        t1 = time.perf_counter()
        sent += len(state["sample"])
        queries += sum(r is not None for r in results)
        answers += [(i, None if results[i] is None
                     else check.answer(results[i].result)) for i in checked]
        del results
        if t1 >= deadline:
            break
    return {"t0": t0, "t1": t1, "sent": sent, "queries": queries,
            "answers": answers, "batch_ends": done_at, "calls": []}
