"""Torch Classifier vs the JAX package's in --seq-mode 3, end to end on
the CPU: long reads of mixed length through the path-DP flow (one row
beyond 2^14 nt, so its batch runs the 7-column path layout), and reads
beyond the row cap redone from chunks through the host-match step.
Identical per-read (name, is_classified, classification, score) tuples,
tolerance 0."""

import os

import numpy as np
import pytest

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams

from torch_port_db import build_db, simulate_long, write_inputs, write_reads
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

LONG = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0, batch_size=4)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "syncmer"])
def dbs(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("long"))
    jdb = build_db(jbuild, root, "jdb", syncmer=request.param)
    genomes, _ = write_inputs(root)
    # mixed lengths: one row beyond 2^14 nt, one read of random sequence
    lens = [1500, 16500, 2400, 900, 3100, 1200]
    reads, _ = simulate_long(genomes, lens, seed=5)
    reads.append(np.random.default_rng(6).choice(
        np.frombuffer(b"ACGT", np.uint8), size=2000))
    path = os.path.join(root, "long.fna")
    write_reads(path, reads)
    return jdb, path


def _tuples(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score)) for q in results]


def _both(jdb, path, tweak=None):
    """(JAX tuples, torch tuples, torch classifier) of one file."""
    jclf = JClassifier(jdb, JParams(**LONG))
    tclf = Classifier(jdb, ClassifyParams(**LONG), device="cpu")
    for c in (jclf, tclf):
        if tweak:
            tweak(c)
    return (_tuples(jclf.classify_file(path)),
            _tuples(tclf.classify_file(path)), tclf)


def test_long_read_classifier_matches_jax(dbs, monkeypatch):
    """--seq-mode 3 through the path-DP flow; the batch holding the
    16,500-nt row runs with the 7-column path layout, and its lanes
    overflow the 16 emission slots, so the retry ladder widens them."""
    from metabuli_work_tpu_torch.ops import dp_cuda

    jdb, path = dbs
    seen = []
    plain = dp_cuda.path_dp_blocked

    def record(*args, **kw):
        seen.append((args[0].shape[2], kw["compact5"], kw["block_w"]))
        return plain(*args, **kw)

    monkeypatch.setattr(dp_cuda, "path_dp_blocked", record)
    ref, got, tclf = _both(jdb, path)
    assert got == ref
    assert sum(t[1] for t in got) >= 6 and not got[-1][1]
    assert {c5 for _, c5, _ in seen} == {True, False}
    assert max(w for w, _, _ in seen) > 3000
    assert tclf._path_block > 16 and tclf.timer.counts["retry"] >= 1


def test_chunked_long_read_matches_jax(dbs):
    """Reads beyond the row cap (lowered on both instances) leave the
    batch pass and are redone from overlapping chunks through the
    host-match step."""
    jdb, path = dbs

    def lower(c):
        c.LONG_ROW_CAP, c._LONG_CHUNK = 3000, 1536

    ref, got, tclf = _both(jdb, path, tweak=lower)
    assert got == ref
    assert got[1][1] and got[4][1]          # the two chunked reads
    assert tclf._match_state is not None    # host-match arrays uploaded
    # each chunked read is timed apart from the batch pass
    counts = tclf.timer.counts
    assert counts["long_probe"] == counts["long_score"] == 2
    assert counts["input"] >= 2
