"""Accession-level and resumable builds of the torch package against the
JAX package: the accession-level build's arrays, taxonomy (one node per
accession under its taxon), accession2index and acc2taxid.map, and a CPU
classify on it (reads called at their accession, as JAX calls them); a
build crashed after a few flushes and resumed, equal to an uninterrupted
build and to JAX's resumed build (the same manifest, the same printed
text); and a resume with a changed parameter, refused with JAX's
message.  Exact equality throughout."""

import json
import os

import numpy as np
import pytest

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index import builder as jbuilder
from metabuli_work_tpu.taxonomy import Taxonomy as JTaxonomy
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import builder as tbuilder
from metabuli_work_tpu_torch.taxonomy import Taxonomy

from torch_port_db import ACGT, simulate_reads, write_inputs, write_reads
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)
PKGS = (("j", jbuilder), ("t", tbuilder))


def _same_files(a, b, names):
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


# ----------------------------------------------------------- accession level
@pytest.fixture(scope="module")
def acc_dbs(tmp_path_factory):
    """write_inputs' four genomes plus a fifth, unrelated one (ACC4)
    under species 10 beside ACC0; each package's accession-level build,
    and reads of ACC0 and ACC4."""
    root = str(tmp_path_factory.mktemp("acc"))
    genomes, p = write_inputs(root)
    extra = ACGT[np.random.default_rng(21).integers(0, 4, size=4000)]
    genomes.append(extra.tobytes().decode())
    with open(os.path.join(root, "g.fna"), "a") as f:
        f.write(f">ACC4 second accession of Sp0\n{genomes[-1]}\n")
    with open(p["acc2taxid"], "a") as f:
        f.write("ACC4\tACC4.1\t10\t0\n")
    dbs = {}
    for who, mod in PKGS:
        dbs[who] = os.path.join(root, f"{who}db")
        mod.build_database(dbs[who], p["fastas"], p["acc2taxid"],
                           p["taxdump"], syncmer=True, mask_mode=0,
                           accession_level=True)
    reads, src = simulate_reads([genomes[0], genomes[4]], 24, seed=22)
    p["reads"] = os.path.join(root, "reads.fna")
    with open(p["reads"], "w") as f:
        for i, (r, s) in enumerate(zip(reads, src)):
            f.write(f">r{i}_ACC{4 * s}\n{r.tobytes().decode()}\n")
    return root, dbs, p


def test_accession_level_build_equals_jax(acc_dbs):
    _, dbs, _ = acc_dbs
    _same_files(dbs["j"], dbs["t"],
                ("kmers.npy", "infos.npy", "species.npy", "taxID_list",
                 "acc2taxid.map", "accession2index"))
    jtax = JTaxonomy.load(os.path.join(dbs["j"], "taxonomy.npz"))
    ttax = Taxonomy.load(os.path.join(dbs["t"], "taxonomy.npz"))
    for k in ("parent", "rank_idx", "name_idx", "int2orig"):
        np.testing.assert_array_equal(getattr(ttax, k), getattr(jtax, k))
    assert list(ttax.rank_pool) == list(jtax.rank_pool)
    assert list(ttax.name_pool) == list(jtax.name_pool)
    assert ttax.num_nodes() == 4 + 4 + 5
    for name in ("j", "t"):
        with open(os.path.join(dbs[name], "db.meta.json")) as f:
            meta = json.load(f)
        assert meta["accession_level"] == 1
    with open(os.path.join(dbs["t"], "accession2index")) as f:
        rows = [ln.split("\t")[0] for ln in f.read().splitlines()]
    assert rows == [f"ACC{i}" for i in range(5)]


def test_accession_level_classify_equals_jax(acc_dbs):
    """The accession-level handshake turns on from the DB's meta in both
    packages; reads are called at their accession as JAX calls them."""
    _, dbs, p = acc_dbs
    clf = Classifier(dbs["t"], ClassifyParams(**PARAMS), device="cpu")
    jclf = JClassifier(dbs["j"], JParams(**PARAMS))
    assert clf.taxonomer.accession_level == jclf.taxonomer.accession_level \
        == 1
    got, want = clf.classify_file(p["reads"]), jclf.classify_file(p["reads"])
    rec = lambda res: [(q.name, q.result.is_classified,
                        q.result.classification, float(q.result.score),
                        dict(q.result.tax_cnt)) for q in res]
    assert rec(got) == rec(want)
    with open(os.path.join(dbs["t"], "accession2index")) as f:
        acc_taxid = dict(ln.split("\t") for ln in f.read().splitlines())
    at_acc = sum(clf.taxonomy.orig_of(q.result.classification)
                 == int(acc_taxid[q.name.split("_")[1]])
                 for q in got)
    assert at_acc >= 18, at_acc


# ------------------------------------------------------------------- resume
# flush after ~4k k-mers: eight 4-kb sequences spill several runs
TINY_RAM = 4096 * 32 / (1 << 30)


@pytest.fixture(scope="module")
def resume_inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    _, p = write_inputs(root, seed=5, n_species=8)
    return root, p


def _build(mod, root, p, name, **kw):
    kw = {"syncmer": False, "mask_mode": 0, "max_ram_gb": TINY_RAM, **kw}
    return mod.build_database(os.path.join(root, name), p["fastas"],
                              p["acc2taxid"], p["taxdump"], **kw)


def _crash(mod, root, p, name, monkeypatch, after=5):
    """A build of `mod` that dies in its sixth add_sequence, leaving its
    spill runs and manifest behind."""
    calls = {"n": 0}
    orig = mod.IndexBuilder.add_sequence

    def bomb(self, seq, taxid_internal, cds_blocks=None):
        calls["n"] += 1
        if calls["n"] > after:
            raise KeyboardInterrupt("simulated crash")
        return orig(self, seq, taxid_internal, cds_blocks)

    with monkeypatch.context() as m:
        m.setattr(mod.IndexBuilder, "add_sequence", bomb)
        with pytest.raises(KeyboardInterrupt):
            _build(mod, root, p, name)
    path = os.path.join(root, name, ".build_runs", "manifest.json")
    with open(path) as f:
        return json.load(f)


def test_resumed_build_equals_uninterrupted_and_jax(resume_inputs,
                                                    monkeypatch, capsys):
    root, p = resume_inputs
    clean = _build(tbuilder, root, p, "clean")
    mans, outs, dbs = {}, {}, {}
    for who, mod in PKGS:
        mans[who] = _crash(mod, root, p, f"{who}resumed", monkeypatch)
        capsys.readouterr()
        dbs[who] = _build(mod, root, p, f"{who}resumed", resume=True)
        outs[who] = capsys.readouterr().out
        assert not os.path.exists(os.path.join(root, f"{who}resumed",
                                               ".build_runs"))
    assert outs["t"] == outs["j"]
    assert outs["t"].startswith("build: resuming after 5 processed records")
    for k in ("sig", "processed", "acc_map", "observed"):
        assert mans["t"][k] == mans["j"][k], k
    assert [os.path.basename(r) for r in mans["t"]["runs"]] == \
        [os.path.basename(r) for r in mans["j"]["runs"]]
    assert 0 < mans["t"]["processed"] < 8 and len(mans["t"]["runs"]) >= 2
    for idx in (clean, dbs["j"]):
        for k in ("values", "taxids", "species"):
            np.testing.assert_array_equal(getattr(dbs["t"], k),
                                          getattr(idx, k))
    _same_files(os.path.join(root, "jresumed"), os.path.join(root, "tresumed"),
                ("kmers.npy", "infos.npy", "species.npy", "acc2taxid.map"))
    _same_files(os.path.join(root, "clean"), os.path.join(root, "tresumed"),
                ("kmers.npy", "infos.npy", "species.npy", "acc2taxid.map"))


def test_resume_with_changed_parameters_refused_as_jax(resume_inputs,
                                                       monkeypatch):
    root, p = resume_inputs
    msgs = {}
    for who, mod in PKGS:
        _crash(mod, root, p, f"{who}changed", monkeypatch)
        with pytest.raises(RuntimeError, match="resume") as e:
            _build(mod, root, p, f"{who}changed", syncmer=True, resume=True)
        msgs[who] = str(e.value).replace(f"{who}changed", "DB")
        # the spilled runs stay for a resume with the original parameters
        assert os.path.exists(os.path.join(root, f"{who}changed",
                                           ".build_runs", "manifest.json"))
    assert msgs["t"] == msgs["j"]
