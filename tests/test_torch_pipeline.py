"""Torch Classifier and CLI vs the JAX package's, end to end on the CPU,
in all three sequence modes and both host flows: identical DB arrays
from both builders, identical per-read (name, is_classified,
classification, score) tuples (tolerance 0, f32 scores bit-equal), and
byte-identical classification and report files."""

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
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from torch_port_db import (build_db, simulate_pairs, simulate_reads,
                           write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)
PAIRED = {**PARAMS, "seq_mode": 2}


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
    # pairs (mate 2 in another length bucket, two pairs of random sequence)
    m1, m2, _ = simulate_pairs(genomes, 20, seed=3)
    m1 = np.concatenate([m1, rnd])
    m2 = np.concatenate([m2, rnd[::-1]])[:, :141]
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2)
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


def _both(jdb, kw, *paths, tweak=None):
    """(JAX tuples, torch tuples) of classify_file under the same params."""
    params = {**PARAMS, **kw}
    jclf = JClassifier(jdb, JParams(**params))
    tclf = Classifier(jdb, ClassifyParams(**params), device="cpu")
    for c in (jclf, tclf):
        if tweak:
            tweak(c)
    return (_tuples(jclf.classify_file(*paths)),
            _tuples(tclf.classify_file(*paths)), tclf)


@pytest.fixture(scope="module")
def jax_paired(dbs):
    """The JAX Classifier's results of the pairs under PARAMS, --seq-mode
    2: one run for the cases that compare with it."""
    root, jdb, _, _ = dbs
    return JClassifier(jdb, JParams(**PAIRED)).classify_file(
        os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna"))


def test_paired_classifier_matches_jax(dbs, jax_paired):
    root, jdb, _, _ = dbs
    r1, r2 = os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna")
    got = _tuples(Classifier(jdb, ClassifyParams(**PAIRED),
                             device="cpu").classify_file(r1, r2))
    assert got == _tuples(jax_paired)
    assert sum(t[1] for t in got) >= 18
    # the second file is read in --seq-mode 2 only
    single = _tuples(Classifier(jdb, ClassifyParams(**PARAMS),
                                device="cpu").classify_file(r1, r2))
    alone = _tuples(Classifier(jdb, ClassifyParams(**PARAMS),
                               device="cpu").classify_file(r1))
    assert single == alone != got


def test_paired_records_carry_both_mates(dbs, jax_paired):
    root, jdb, _, _ = dbs
    r1, r2 = os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna")
    ref = jax_paired
    got = Classifier(jdb, ClassifyParams(**PAIRED),
                     device="cpu").classify_file(r1, r2)
    assert [(q.length1, q.length2, q.total_length, q.covered_length)
            for q in got] == [(q.length1, q.length2, q.total_length,
                               q.covered_length) for q in ref]
    assert got[0].length2 == 141 and got[0].covered_length == 147 + 138


def test_host_match_state_uploads_at_first_use(dbs):
    root, jdb, _, reads = dbs
    clf = Classifier(jdb, ClassifyParams(**PARAMS), device="cpu")
    clf.classify_file(reads)
    assert clf._match_state is None         # the path-DP flow never needs it
    clf = Classifier(jdb, ClassifyParams(**{**PARAMS, "min_cons_cnt": 1}),
                     device="cpu")
    assert not clf.use_device_dp and not hasattr(clf, "db_quad")
    clf.classify_file(reads)
    assert clf._match_state["db_values"].dtype.is_signed


@pytest.mark.parametrize("seq_mode", [1, 2])
def test_host_match_classifier_matches_jax(dbs, seq_mode):
    """min_cons_cnt=1 leaves the path DP's validity domain: every batch
    takes the host-match flow."""
    root, jdb, _, reads = dbs
    paths = (reads,) if seq_mode == 1 else (os.path.join(root, "r1.fna"),
                                            os.path.join(root, "r2.fna"))
    ref, got, tclf = _both(jdb, dict(seq_mode=seq_mode, min_cons_cnt=1),
                           *paths)
    assert got == ref
    assert sum(t[1] for t in got) >= 18
    assert tclf.total_match_cnt > 0


def test_cli_paired_outputs_byte_identical(dbs, capsys):
    root, jdb, _, _ = dbs
    r1, r2 = os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna")
    args = [r1, r2, jdb, None, "job", "--seq-mode", "2", "--min-score",
            "0.15", "--batch-size", "8"]
    jout, tout = os.path.join(root, "jout2"), os.path.join(root, "tout2")
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
    # --seq-mode 2 with one file classifies it unpaired, as the JAX CLI does
    args = [r1, jdb, None, "one", "--seq-mode", "2", "--batch-size", "8"]
    assert jcli.main(["classify"] + [a or jout for a in args]
                     + ["--devices", "1"]) == 0
    assert tcli.main(["classify"] + [a or tout for a in args]
                     + ["--device", "cpu"]) == 0
    with open(os.path.join(jout, "one_classifications.tsv"), "rb") as f:
        ref = f.read()
    with open(os.path.join(tout, "one_classifications.tsv"), "rb") as f:
        assert f.read() == ref


def test_unported_configurations_raise(dbs, monkeypatch):
    _, jdb, _, _ = dbs
    # the flows this test used to refuse now run, --em too
    for kw in (dict(seq_mode=2), dict(seq_mode=3), dict(min_cons_cnt=1),
               dict(hbm_budget_gb=1.0), dict(em=True)):
        Classifier(jdb, ClassifyParams(**{**PARAMS, **kw}), device="cpu")
    assert Classifier(jdb, ClassifyParams(**PARAMS),
                      mesh=make_mesh(2, devices=["cpu"] * 2)).mesh is not None
    monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    assert Classifier(jdb, ClassifyParams(**PARAMS),
                      device="cpu")._device_assign
    # --em keeps per-read species scores, which device-assign lacks
    assert not Classifier(jdb, ClassifyParams(**{**PARAMS, "em": True}),
                          device="cpu")._device_assign


def test_mate_files_of_different_length_raise(dbs, tmp_path):
    """A mate-2 file shorter or longer than mate 1 is named, with the
    read count seen (the JAX package ends in a bare RuntimeError)."""
    root, jdb, _, _ = dbs
    r1 = os.path.join(root, "r1.fna")
    short = str(tmp_path / "short.fna")
    with open(os.path.join(root, "r2.fna")) as f, open(short, "w") as g:
        g.writelines(f.readlines()[:2 * 13])          # 13 of 22 reads
    clf = Classifier(jdb, ClassifyParams(**{**PARAMS, "seq_mode": 2}),
                     device="cpu")
    with pytest.raises(ValueError, match=r"short\.fna ends after 13 reads"):
        clf.classify_file(r1, short)
    with pytest.raises(ValueError, match=r"short\.fna ends after 13 reads.*"
                                         r"r1\.fna has more"):
        clf.classify_file(short, r1)


def test_block_overflow_doubles_once_for_queued_batches(dbs, tmp_path):
    """Two batches queued together that both overflow the blocked path
    emission ran with the same block: the sticky block doubles once,
    from the value they were dispatched with, not once per batch."""
    root, jdb, _, reads = dbs
    with open(reads) as f:
        first8 = f.readlines()[:16]
    twice = str(tmp_path / "twice.fna")
    with open(twice, "w") as f:
        f.writelines(first8 + first8)                  # two equal batches
    one = str(tmp_path / "one.fna")
    with open(one, "w") as f:
        f.writelines(first8)
    # the block one such batch settles at, climbing from 1
    probe = Classifier(jdb, ClassifyParams(**PARAMS), device="cpu")
    probe._path_block = 1
    probe.classify_file(one)
    settled = probe._path_block
    assert settled >= 2
    clf = Classifier(jdb, ClassifyParams(**PARAMS), device="cpu")
    clf._path_block = settled // 2              # both batches overflow
    got = _tuples(clf.classify_file(twice))
    assert clf._path_block == settled
    ref = _tuples(Classifier(jdb, ClassifyParams(**PARAMS),
                             device="cpu").classify_file(twice))
    assert got == ref


@pytest.mark.parametrize("dbs", [True], indirect=True, ids=["syncmer"])
def test_debug_retry_line_matches_jax(dbs, monkeypatch, capfd):
    _, jdb, _, reads = dbs
    monkeypatch.setenv("METABULI_DEBUG_RETRY", "1")
    p = dict(PARAMS, batch_size=32)
    out = []
    for clf in (JClassifier(jdb, JParams(**p)),
                Classifier(jdb, ClassifyParams(**p), device="cpu")):
        clf._path_block = 2       # blocked-emission overflow: a retry
        capfd.readouterr()
        clf.classify_file(reads)
        out.append([ln for ln in capfd.readouterr().err.splitlines()
                    if ln.startswith("# retry")])
    assert out[0] and out[1] == out[0]
