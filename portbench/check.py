"""The comparison that decides `correct`.

Before the window, a sample of the timed queries is drawn from the
seed (stream 3), with the longest query always in it; the window keeps
the program's answer to each every time it answers it.  After the
window each is classified again by the plain reference (reference/),
which builds its own index from the same genomes and reads the same
sequences.  An answer is a mismatch unless the program's (classified,
taxon, score) equals the reference's exactly, the score compared as
float32.  A query of the window with no result is missing.

Limits, with the readings they were set from, are in PERF.md: both
numbers are exact comparisons, so both limits are 0.
"""

import os
import time

import numpy as np

from .reference.classify import Reference, build_index
from .reference.taxonomy import Taxonomy

LIMITS = {"mismatched_reads": 0, "missing_results": 0}
REF_VERSION = "1"


def reference_index(config, genomes, species, cache_dir):
    """The reference's own index of the genomes, built by the reference
    and kept under cache_dir (keyed by the configuration's key)."""
    os.makedirs(cache_dir, exist_ok=True)
    v = os.path.join(cache_dir, "values.npy")
    s = os.path.join(cache_dir, "species.npy")
    if os.path.exists(v) and os.path.exists(s):
        return np.load(v, mmap_mode="r"), np.load(s, mmap_mode="r")
    values, sp = build_index(genomes, species, config["syncmer"],
                             config["smer_len"])
    for path, a in ((v, values), (s, sp)):
        tmp = path + ".tmp.npy"
        np.save(tmp, a)
        os.replace(tmp, path)
    return values, sp


def make_reference(config, traffic, values, species, parent, ranks,
                   precision="float32"):
    """The reference under the mix's settings (its `params` may set the
    scorer's min_cons_cnt, min_cons_cnt_euk and tie_ratio)."""
    extra = {k: v for k, v in traffic.get("params", {}).items()
             if k in ("min_cons_cnt", "min_cons_cnt_euk", "tie_ratio")}
    return Reference(values, species, Taxonomy(parent, ranks),
                     syncmer=config["syncmer"], smer_len=config["smer_len"],
                     seq_mode=traffic["seq_mode"],
                     min_score=traffic["min_score"],
                     min_sp_score=traffic["min_sp_score"],
                     precision=precision, **extra)


def pick(sample, k, rng):
    """k query indices of the sample, drawn from rng before the window,
    with the longest query among them."""
    n = len(sample)
    if n == 0:
        return []
    lens = sample.lengths(1)
    if sample.seqs2 is not None:
        lens = lens + sample.lengths(2)
    chosen = rng.choice(n, size=min(k, n), replace=False)
    return sorted(set(chosen.tolist()) | {int(np.argmax(lens))})


def answer(res):
    """(classified, taxon, float32 score) of a program or reference
    result."""
    return (bool(res.is_classified), int(res.classification),
            np.float32(res.score))


def compare(sample, answers, reference):
    """(mismatches, seconds, queries the reference classified):
    `answers` holds (query, answer under test) pairs, a query once for
    each time the window answered it; None (no result) is left to
    missing_results.  The reference classifies each query once."""
    t0 = time.perf_counter()
    ref = {}
    bad = 0
    for i, got in answers:
        if got is None:
            continue
        if i not in ref:
            ref[i] = answer(reference.classify(sample.mate(i, 1),
                                               sample.mate(i, 2)))
        bad += got != ref[i]
    return bad, time.perf_counter() - t0, len(ref)


def checks(mismatched, missing):
    return {"mismatched_reads": {"value": mismatched,
                                 "limit": LIMITS["mismatched_reads"]},
            "missing_results": {"value": missing,
                                "limit": LIMITS["missing_results"]}}


def passed(chk):
    return all(c["value"] <= c["limit"] for c in chk.values())
