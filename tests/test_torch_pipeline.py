"""Torch Classifier and CLI vs the JAX package's, end to end on the CPU:
identical DB arrays from both builders, identical per-read
(is_classified, classification, score) tuples, and byte-identical
classification and report files."""

import os

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.index.format import load_index as jload
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index.builder import build_database as tbuild
from metabuli_work_tpu_torch.index.format import load_index as tload

from torch_port_db import build_db, simulate_reads, write_inputs, write_reads

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "syncmer"])
def dbs(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe"))
    jdb = build_db(jbuild, root, "jdb", syncmer=request.param)
    tdb = build_db(tbuild, root, "tdb", syncmer=request.param)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=2)
    rnd = np.random.default_rng(8).choice(np.frombuffer(b"ACGT", np.uint8),
                                          size=(2, reads.shape[1]))
    path = os.path.join(root, "reads.fna")
    write_reads(path, np.concatenate([reads, rnd]))
    return root, jdb, tdb, path


def _tuples(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score)) for q in results]


def test_builders_give_identical_index(dbs):
    _, jdb, tdb, _ = dbs
    a, b = jload(jdb), tload(tdb)
    for k in ("values", "taxids", "species"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.meta["syncmer"] == b.meta["syncmer"]
    np.testing.assert_array_equal(a.taxonomy.parent, b.taxonomy.parent)


def test_classifier_matches_jax(dbs):
    _, jdb, _, reads = dbs
    ref = _tuples(JClassifier(jdb, JParams(**PARAMS)).classify_file(reads))
    got = _tuples(Classifier(jdb, ClassifyParams(**PARAMS),
                             device="cpu").classify_file(reads))
    assert got == ref
    assert sum(t[1] for t in got) >= 20


def test_cli_outputs_byte_identical(dbs, capsys):
    root, jdb, _, reads = dbs
    args = [reads, jdb, None, "job", "--seq-mode", "1", "--min-score",
            "0.15", "--batch-size", "8"]
    jout, tout = os.path.join(root, "jout"), os.path.join(root, "tout")
    assert jcli.main(["classify"] + [a or jout for a in args]
                     + ["--devices", "1"]) == 0
    assert tcli.main(["classify"] + [a or tout for a in args]
                     + ["--device", "cpu"]) == 0
    for name in ("job_classifications.tsv", "job_report.tsv"):
        with open(os.path.join(jout, name), "rb") as f:
            ref = f.read()
        with open(os.path.join(tout, name), "rb") as f:
            assert f.read() == ref, name
        assert ref


def test_unported_configurations_raise(dbs):
    _, jdb, _, _ = dbs
    for kw in (dict(seq_mode=2), dict(min_cons_cnt=1), dict(em=True),
               dict(hbm_budget_gb=1.0)):
        p = ClassifyParams(**{**PARAMS, **kw})
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Classifier(jdb, p, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Classifier(jdb, ClassifyParams(**PARAMS), mesh=object(), device="cpu")
