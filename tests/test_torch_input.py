"""The torch package's input layer against the JAX package: validation
(--validate-input), the native C++ batch reader (FASTA, FASTQ, gzip,
names past the 128-byte stride), row masking, and classify_file through
either reader; a read longer than the native reader's 4,096-base rows
outside --seq-mode 3; mate files of different length.  Exact equality."""

import gzip
import os

import numpy as np
import pytest

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.io import native_reader as jnative
from metabuli_work_tpu.io.validate import validate_input as jvalidate
from metabuli_work_tpu.ops import mask as jmask
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.io import native_reader as tnative
from metabuli_work_tpu_torch.io.validate import validate_input as tvalidate
from metabuli_work_tpu_torch.ops import mask as tmask

from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)

# the cases of tests/test_validate_mtbl.py, and gzip
VALIDATE = {
    "ok.fna": ">a\nACGT\nACGT\n>b\nTTTT\n",
    "before-header.fna": "ACGT\n>a\nACGT\n",
    "duplicate.fna": ">a\nACGT\n>a\nTTTT\n",
    "no-sequence.fna": ">a\n>b\nACGT\n",
    "bad-char.fna": ">a\nAC#T\n",
    "ok.fq": "@r1\nACGT\n+\nIIII\n@r2\nTT\n+\nII\n",
    "qual-length.fq": "@r1\nACGT\n+\nIII\n",
    "ok.fq.gz": "@r1\nACGT\n+\nIIII\n",
}


def _write(path, text):
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.mark.parametrize("name", sorted(VALIDATE))
def test_validate_input_equals_jax(tmp_path, name):
    path = _write(str(tmp_path / name), VALIDATE[name])
    got = tvalidate(path)
    assert got == jvalidate(path)
    assert got[0] == name.startswith("ok")


def _records(rng, n, long_names=False):
    out = []
    for i in range(n):
        name = f"read{i}" + ("x" * 150 if long_names and i % 2 else "")
        seq = rng.choice(list("ACGTN"), int(rng.integers(1, 300)))
        out.append((name, "".join(seq)))
    return out


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fastq.gz",
                                  "long-names"])
def test_native_batches_equal_jax(tmp_path, kind):
    """Batches of 16 from 40 records, rows 128 wide: names, rows (bases
    past 128 dropped) and lengths (the whole read's) as JAX's reader
    gives them; FASTA records wrap at 60 columns."""
    assert tnative.available()
    recs = _records(np.random.default_rng(len(kind)), 40,
                    long_names=kind == "long-names")
    if kind.startswith("fastq"):
        text = "".join(f"@{n} c\n{s}\n+\n{'I' * len(s)}\n" for n, s in recs)
    else:
        text = "".join(f">{n} c\n" + "".join(
            s[k:k + 60] + "\n" for k in range(0, len(s), 60))
            for n, s in recs)
    path = _write(str(tmp_path / ("r." + kind.replace("long-names", "fa"))),
                  text)
    got = list(tnative.NativeBatchReader(path, 16, 128))
    ref = list(jnative.NativeBatchReader(path, 16, 128))
    assert [len(b[0]) for b in got] == [16, 16, 8]
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])
    assert [len(s) for _, s in recs] == [int(x) for b in got for x in b[2]]
    if kind == "long-names":
        assert max(len(n) for b in got for n in b[0]) == 127


def test_mask_batch_rows_equals_jax():
    rng = np.random.default_rng(3)
    seqs = []
    for _ in range(6):
        s = "".join(rng.choice(list("ACGT"), 300))
        seqs.append(s[:100] + "AT" * 15 + s[130:])
    lens = np.array([300, 250, 300, 120, 300, 0], np.int32)
    arr = np.full((6, 320), ord("N"), np.uint8)
    for i, s in enumerate(seqs):
        arr[i, :lens[i]] = np.frombuffer(s[:lens[i]].encode(), np.uint8)
    got = tmask.mask_batch_rows(arr.copy(), lens, 0.9)
    np.testing.assert_array_equal(got, jmask.mask_batch_rows(arr.copy(),
                                                              lens, 0.9))
    for i, s in enumerate(seqs):
        assert got[i, :lens[i]].tobytes().decode() == \
            tmask.mask_low_complexity(s[:lens[i]], 0.9)
    assert (got == ord("N")).sum() > (arr == ord("N")).sum()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("input"))
    jdb = build_db(jbuild, root, "jdb", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=31)
    path = os.path.join(root, "reads.fq")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i} x\n{r.tobytes().decode()}\n+\n{'I' * len(r)}\n")
    m1, m2, _ = simulate_pairs(genomes, 20, seed=32)
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2[:, :141])
    return root, jdb, path, genomes


def _tuples(results):
    return [(q.name, q.length1, q.length2, q.result.is_classified,
             q.result.classification, float(q.result.score),
             dict(q.result.tax_cnt)) for q in results]


def _jax(jdb, params, paths, native, monkeypatch, tweak=None):
    """The JAX classifier's records through its native reader or, with
    the reader's library reported missing, its Python reader."""
    with monkeypatch.context() as m:
        if not native:
            m.setattr(jnative, "available", lambda: False)
        clf = JClassifier(jdb, JParams(**params))
        if tweak:
            tweak(clf)
        return _tuples(clf.classify_file(*paths))


def _classify(clf, paths, reader, monkeypatch):
    """classify_file through the given reader: the Python reader runs
    when the native library is reported missing."""
    with monkeypatch.context() as m:
        if reader == "python":
            m.setattr(tnative, "available", lambda: False)
        return clf.classify_file(*paths)


_JAX = {}      # JAX's records by mode, made once (its compiles dominate)


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("mode", ["single", "paired", "masked"])
def test_classify_file_through_either_reader_equals_jax(db, reader, mode,
                                                        monkeypatch):
    """Each torch reader against JAX's classify_file through its native
    reader (on these reads JAX's two readers agree; the read where they
    do not is the next test's)."""
    root, jdb, path, _ = db
    params = {**PARAMS, **{"paired": dict(seq_mode=2),
                           "masked": dict(mask_mode=1)}.get(mode, {})}
    paths = (path,) if mode != "paired" else (
        os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna"))
    clf = Classifier(jdb, ClassifyParams(**params), device="cpu")
    got = _tuples(_classify(clf, paths, reader, monkeypatch))
    assert clf.reader == reader and clf.timer.counts["input"] >= 3
    if mode not in _JAX:
        _JAX[mode] = _jax(jdb, params, paths, True, monkeypatch)
    assert got == _JAX[mode]
    assert sum(t[3] for t in got) >= 18


def test_read_longer_than_native_rows_single_end(db, tmp_path, monkeypatch):
    """A 5,000-base read in --seq-mode 1: the native reader's 4,096-base
    row drops its tail.  The torch package widens that batch and
    classifies the whole read, through either reader, as JAX's Python
    reader does; JAX's native path classifies its first 4,096 bases
    (ROADMAP.md, Queue 3)."""
    _, jdb, path, genomes = db
    (long_read,), _ = simulate_long(genomes, [5000], seed=33)
    reads = str(tmp_path / "mixed.fna")
    with open(path) as f, open(reads, "w") as g:
        lines = f.readlines()                  # one short read, then it
        g.write(">" + lines[0][1:] + lines[1])
        g.write(f">long\n{long_read.tobytes().decode()}\n")
    def block64(c):             # where the retry ladder settles: skip it
        c._path_block = 64

    ref = _jax(jdb, PARAMS, (reads,), False, monkeypatch, block64)
    for reader in ("native", "python"):
        clf = Classifier(jdb, ClassifyParams(**PARAMS), device="cpu")
        block64(clf)
        got = _tuples(_classify(clf, (reads,), reader, monkeypatch))
        assert got == ref and clf.reader == reader
        assert clf.timer.counts["retry"] == 0
    assert ref[-1][1] == 5000 and ref[-1][3]
    jax_native = _jax(jdb, PARAMS, (reads,), True, monkeypatch, block64)
    assert jax_native[-1][1] == 4096 and jax_native[:-1] == ref[:-1]


def test_mate_files_of_different_length_raise_native(db, tmp_path):
    root, jdb, _, _ = db
    r1 = os.path.join(root, "r1.fna")
    short = str(tmp_path / "short.fna")
    with open(os.path.join(root, "r2.fna")) as f, open(short, "w") as g:
        g.writelines(f.readlines()[:2 * 13])           # 13 of 20 reads
    clf = Classifier(jdb, ClassifyParams(**{**PARAMS, "seq_mode": 2}),
                     device="cpu")
    with pytest.raises(ValueError, match=r"short\.fna ends after 13 reads"):
        clf.classify_file(r1, short)
    with pytest.raises(ValueError, match=r"short\.fna ends after 13 reads.*"
                                         r"r1\.fna has more"):
        clf.classify_file(short, r1)
    eight = str(tmp_path / "eight.fna")
    with open(r1) as f, open(eight, "w") as g:
        g.writelines(f.readlines()[:2 * 8])            # one whole batch
    with pytest.raises(ValueError, match=r"eight\.fna ends after 8 reads.*"
                                         r"r1\.fna has more"):
        clf.classify_file(eight, r1)
    assert clf.reader == "native"
