"""Timed entry "classify_batch": a caller that holds its reads as
strings in memory sends Classifier.classify_batch calls of `batch`
reads, each after the last has returned its records, until --seconds
have passed; the window ends when the last call returns.  The reads
come from a pool of the mix's `sample_queries` (stream 2 of the seed),
the same size for every seed, which the caller goes round.  Like a
caller that passes its records on, it keeps of each call only the
answers the check compares."""

import time

from portbench import check

WARMUP_PASSES = 2


def _calls(run, sample, checked=()):
    """(first query, names, mates 1, mates 2, checked queries of the
    call as (place in the call, query)) of each call."""
    t = run.traffic
    B = t["batch"]
    s1 = run.gen.as_strings(sample.seqs1)
    s2 = run.gen.as_strings(sample.seqs2) if sample.seqs2 is not None \
        else None
    out = []
    for i in range(0, len(s1), B):
        names = [f"r{j}" for j in range(i, min(i + B, len(s1)))]
        mine = [(q - i, q) for q in checked if i <= q < i + B]
        out.append((i, names, s1[i:i + B],
                    s2[i:i + B] if s2 is not None else None, mine))
    return out


def warm(run):
    t = run.traffic
    sample = run.gen.draw(run.genomes, t, t["warmup_batches"] * t["batch"],
                          run.rng(1))
    calls = _calls(run, sample)
    rate = 0.0
    for _ in range(WARMUP_PASSES):
        t0 = time.perf_counter()
        for _, names, s1, s2, _ in calls:
            run.clf.classify_batch(names, s1, s2)
        rate = len(sample) / (time.perf_counter() - t0)
    return rate


def prepare(run):
    sample = run.gen.draw(run.genomes, run.traffic,
                          run.traffic["sample_queries"], run.rng(2))
    checked = check.pick(sample, run.traffic["check_reads"], run.rng(3))
    return {"sample": sample, "checked": checked,
            "calls": _calls(run, sample, checked)}


def window(run, state):
    calls = state["calls"]
    answers, ends, ms = [], [], []
    n = sent = 0
    k = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        if run.slice is not None:
            run.slice.poll()
        _, names, s1, s2, mine = calls[k % len(calls)]
        sent += len(names)
        c0 = time.perf_counter()
        recs = run.clf.classify_batch(names, s1, s2)
        c1 = time.perf_counter()
        ends.append(c1)
        ms.append((c0, (c1 - c0) * 1e3))
        n += sum(r is not None for r in recs)
        answers += [(q, None if recs[j] is None
                     else check.answer(recs[j].result)) for j, q in mine]
        k += 1
        if c1 >= deadline:
            break
    return {"t0": t0, "t1": c1, "sent": sent, "queries": n,
            "answers": answers, "batch_ends": ends, "calls": ms}
