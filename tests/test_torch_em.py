"""--em in the torch package against the JAX package: the CLI's mapping
and EM files byte-identical, the per-read species score lists the EM
pass reads equal in every flow that runs under --em (host scoring,
host-match, DB-range streaming, the mesh, reads beyond the row cap), and
--em keeping the device-assign flow off."""

import os

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index.builder import build_database as tbuild
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from torch_port_db import (build_db, simulate_long, simulate_reads,
                           write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8,
              em=True)
LONG = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0, batch_size=4,
            em=True)
EM_FILES = ("_mapping_results.txt", "_EM_report.tsv",
            "_EM+reclassify_results.tsv", "_EM+reclassify_report.tsv",
            "_classifications.tsv")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One DB from each builder (the EM pass caches per-species counts in
    the DB directory, so each package gets its own), short reads with two
    of random sequence, and long reads for the chunk pass."""
    root = str(tmp_path_factory.mktemp("em"))
    jdb = build_db(jbuild, root, "jdb", syncmer=True)
    tdb = build_db(tbuild, root, "tdb", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=12)
    rnd = np.random.default_rng(13).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    path = os.path.join(root, "reads.fna")
    write_reads(path, np.concatenate([reads, rnd]))
    long_reads, _ = simulate_long(genomes, [1500, 3100, 900], seed=14)
    long_path = os.path.join(root, "long.fna")
    write_reads(long_path, long_reads)
    return root, jdb, tdb, path, long_path


def test_em_files_equal_jax(dbs, monkeypatch):
    """classify --em through both CLIs, with METABULI_DEVICE_ASSIGN=1 set:
    --em keeps both on the host-scoring flow."""
    root, jdb, tdb, path, _ = dbs
    monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    args = [path, None, None, "job", "--seq-mode", "1", "--min-score",
            "0.15", "--batch-size", "8", "--em"]
    jout, tout = os.path.join(root, "jout"), os.path.join(root, "tout")
    assert jcli.main(["classify"] + [a or b for a, b in zip(
        args, [None, jdb, jout] + [None] * 8)] + ["--devices", "1"]) == 0
    assert tcli.main(["classify"] + [a or b for a, b in zip(
        args, [None, tdb, tout] + [None] * 8)] + ["--device", "cpu"]) == 0
    for suffix in EM_FILES:
        with open(os.path.join(jout, "job" + suffix), "rb") as f:
            ref = f.read()
        with open(os.path.join(tout, "job" + suffix), "rb") as f:
            assert f.read() == ref, suffix
        assert ref, suffix
    assert os.path.exists(os.path.join(tdb, "sp2uniqKmerCnt"))
    clf = Classifier(tdb, ClassifyParams(**PARAMS), device="cpu")
    assert not clf._device_assign


def _scores(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score),
             [(int(s), float(c)) for s, c in q.result.species_scores])
            for q in results]


def _lower_row_cap(c):
    c.LONG_ROW_CAP, c._LONG_CHUNK = 3000, 1536


@pytest.mark.parametrize("flow", ["host-scoring", "host-match", "streamed",
                                  "mesh", "beyond-row-cap"])
def test_em_species_scores_in_every_flow(dbs, flow):
    """Each flow's per-read species score lists (and classifications)
    equal the JAX package's under --em; the mesh and the streamed index
    are held to JAX's resident run, the rest to the same flow in JAX."""
    _, jdb, tdb, path, long_path = dbs
    kw = {"host-match": dict(min_cons_cnt=1),
          "streamed": dict(hbm_budget_gb=1e-4)}.get(flow, {})
    base = LONG if flow == "beyond-row-cap" else PARAMS
    reads = long_path if flow == "beyond-row-cap" else path
    jclf = JClassifier(jdb, JParams(**base, **kw))
    tclf = Classifier(tdb, ClassifyParams(**base, **kw), device="cpu",
                      mesh=make_mesh(2, devices=["cpu"] * 2)
                      if flow == "mesh" else None)
    if flow == "beyond-row-cap":
        for c in (jclf, tclf):
            _lower_row_cap(c)
    ref = _scores(jclf.classify_file(reads))
    got = _scores(tclf.classify_file(reads))
    assert got == ref
    assert sum(bool(r[4]) for r in got) >= 2
    assert tclf._streaming == (flow == "streamed")
    if flow == "beyond-row-cap":
        assert tclf.timer.counts["long_score"] == 1 and got[1][4]
