"""Database upkeep and contaminant removal in the torch package against
the JAX package: update_database with and without grafted new taxa (the
merged arrays, taxonomy and files, and a CPU classify on the result),
filter_reads single-end and paired over a list of two DBs (the same kept
and removed files and printed text), and the METABULI_PACK_CACHE setting
("0" turns the packing cache off, a path moves it).  Exact equality
throughout.  Also the one place the port differs by design: it updates a
reference-format DB with the parameters its db.parameters gives, where
the JAX package cannot open such a DB."""

import os
import shutil

import numpy as np
import pytest

from metabuli_work_tpu.classify.filter import filter_reads as jfilter
from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index import builder as jbuilder
from metabuli_work_tpu.index import update as jupdate
from metabuli_work_tpu.taxonomy import Taxonomy as JTaxonomy
from metabuli_work_tpu_torch.classify.filter import filter_reads as tfilter
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import builder as tbuilder
from metabuli_work_tpu_torch.index.delta import encode_metamer_deltas
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.index import prodigal as tprodigal
from metabuli_work_tpu_torch.index import update as tupdate
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.taxonomy import Taxonomy

from torch_port_db import (ACGT, simulate_pairs, simulate_reads,
                           write_inputs, write_reads, write_taxonomy_blob)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)


def _records(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score), dict(q.result.tax_cnt)) for q in results]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Each package's syncmer DB of write_inputs' four genomes; two new
    genomes with their FASTA lists and acc2taxid files (NEW1 under the
    existing species 12, NEW2 under species 20 of a new genus 5, grafted
    by new_taxa.tsv); a DB of NEW2 alone; single-end reads and pairs of
    all six genomes plus random reads."""
    root = str(tmp_path_factory.mktemp("upkeep"))
    genomes, p = write_inputs(root)
    rng = np.random.default_rng(31)
    new = [ACGT[rng.integers(0, 4, size=4000)].tobytes().decode()
           for _ in range(2)]
    for k, (taxid, g) in enumerate(zip((12, 20), new), 1):
        fa = os.path.join(root, f"new{k}.fna")
        with open(fa, "w") as f:
            f.write(f">NEW{k}.1\n{g}\n")
        p[f"fastas{k}"] = os.path.join(root, f"new{k}.txt")
        with open(p[f"fastas{k}"], "w") as f:
            f.write(fa + "\n")
        p[f"acc2taxid{k}"] = os.path.join(root, f"new{k}.map")
        with open(p[f"acc2taxid{k}"], "w") as f:
            f.write(f"accession\taccession.version\ttaxid\tgi\n"
                    f"NEW{k}\tNEW{k}.1\t{taxid}\t0\n")
    p["new_taxa"] = os.path.join(root, "new_taxa.tsv")
    with open(p["new_taxa"], "w") as f:
        f.write("#taxid\tparent\trank\tname\n5\t1\tgenus\tG3\n"
                "20\t5\tspecies\tSp20\n")
    # the taxdump with G3 and Sp20, for the DB of NEW2 alone
    p["taxdump2"] = os.path.join(root, "taxdump2")
    shutil.copytree(p["taxdump"], p["taxdump2"])
    with open(os.path.join(p["taxdump2"], "nodes.dmp"), "a") as f:
        f.write("5\t|\t1\t|\tgenus\t|\n20\t|\t5\t|\tspecies\t|\n")
    with open(os.path.join(p["taxdump2"], "names.dmp"), "a") as f:
        f.write("5\t|\tG3\t|\t\t|\tscientific name\t|\n"
                "20\t|\tSp20\t|\t\t|\tscientific name\t|\n")
    dbs = {}
    for who, mod in (("j", jbuilder), ("t", tbuilder)):
        dbs[who] = os.path.join(root, f"{who}base")
        mod.build_database(dbs[who], p["fastas"], p["acc2taxid"],
                           p["taxdump"], syncmer=True, mask_mode=0)
        dbs[f"{who}new2"] = os.path.join(root, f"{who}new2")
        mod.build_database(dbs[f"{who}new2"], p["fastas2"], p["acc2taxid2"],
                           p["taxdump2"], syncmer=True, mask_mode=0)
    everything = genomes + new
    reads, p["src"] = simulate_reads(everything, 30, seed=32)
    reads = np.concatenate([reads, ACGT[rng.integers(0, 4, size=(6, 150))]])
    p["reads"] = os.path.join(root, "reads.fna")
    write_reads(p["reads"], reads)
    m1, m2, _ = simulate_pairs(everything, 18, seed=33)
    for k, m in ((1, m1), (2, m2)):
        p[f"mate{k}"] = os.path.join(root, f"mate{k}.fq")
        with open(p[f"mate{k}"], "w") as f:
            for i, r in enumerate(m):
                f.write(f"@p{i} mate{k}\n{r.tobytes().decode()}\n+\n"
                        f"{'I' * len(r)}\n")
    return root, dbs, p


@pytest.fixture(scope="module")
def updated(base):
    """Each package's update of its base DB with NEW1 (an existing
    taxon, "plain") and with NEW2 under grafted new taxa ("taxa")."""
    root, dbs, p = base
    out = {}
    for tag, k in (("plain", 1), ("taxa", 2)):
        for who, mod in (("j", jupdate), ("t", tupdate)):
            d = out[f"{who}{tag}"] = os.path.join(root, f"{who}upd_{tag}")
            merged = mod.update_database(
                dbs[who], d, p[f"fastas{k}"], p[f"acc2taxid{k}"],
                new_taxa_path=p["new_taxa"] if k == 2 else None)
            assert merged.size > load_index(dbs["t"]).size
    return out


@pytest.mark.parametrize("new_taxa", [False, True],
                         ids=["existing-taxon", "new-taxa"])
def test_update_database_equals_jax(base, updated, new_taxa):
    """updateDB merges the old entries with the new sequences' under the
    LCA dedup; the files and taxonomy equal JAX's, and so does a CPU
    classify on the DB with new taxa (one JAX trace a DB, so the other
    DB's classify is checked on the port alone)."""
    root, dbs, p = base
    k = 2 if new_taxa else 1
    tag = "taxa" if new_taxa else "plain"
    out = {who: updated[f"{who}{tag}"] for who in "jt"}
    for f in ("kmers.npy", "infos.npy", "species.npy", "taxID_list",
              "acc2taxid.map"):
        with open(os.path.join(out["j"], f), "rb") as a, \
                open(os.path.join(out["t"], f), "rb") as b:
            assert a.read() == b.read(), f
    jtax = JTaxonomy.load(os.path.join(out["j"], "taxonomy.npz"))
    ttax = Taxonomy.load(os.path.join(out["t"], "taxonomy.npz"))
    for a in ("parent", "rank_idx", "name_idx", "int2orig"):
        np.testing.assert_array_equal(getattr(ttax, a), getattr(jtax, a))
    assert list(ttax.name_pool) == list(jtax.name_pool)
    assert (ttax.to_internal(20) != 0) == new_taxa
    got = Classifier(out["t"], ClassifyParams(**PARAMS),
                     device="cpu").classify_file(p["reads"])
    if new_taxa:
        want = JClassifier(out["j"], JParams(**PARAMS)).classify_file(
            p["reads"])
        assert _records(got) == _records(want)
    # the new genome's reads (genome 3 + k of the six) land on its taxon
    on_new = [q for q, g in zip(got, p["src"]) if g == 3 + k]
    assert on_new and all(ttax.orig_of(q.result.classification) in
                          ((12, 2) if k == 1 else (20, 5)) for q in on_new)


def test_update_with_an_unknown_parent_exits_as_jax(base, tmp_path):
    root, dbs, p = base
    bad = tmp_path / "bad.tsv"
    bad.write_text("21\t999\tspecies\tOrphan\n")
    msgs = []
    for who, mod in (("j", jupdate), ("t", tupdate)):
        with pytest.raises(SystemExit) as e:
            mod.update_database(dbs[who], str(tmp_path / who), p["fastas2"],
                                p["acc2taxid2"], new_taxa_path=str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "new taxon 21: parent 999 not in taxonomy"


def _filter(fn, who, root, db_list, reads2, reads1, capsys, case, **kw):
    out = os.path.join(root, f"{who}filter_{case}")
    seq_mode = 2 if reads2 else 1
    params = (ClassifyParams if who == "t" else JParams)(
        seq_mode=seq_mode, min_score=0.15, min_sp_score=0.5, batch_size=8)
    capsys.readouterr()
    paths = fn(reads1, db_list, out, "job", params, reads2, **kw)
    text = capsys.readouterr().out.replace(out, "OUT")
    files = {os.path.basename(f): open(f, "rb").read()
             for pair in paths for f in pair}
    return text, files


# (case, mate files?, DB list); one JAX trace a DB and read layout, so the
# paired cases take one DB each and the single-end case the list of two
FILTERS = [("single-end", False, ("taxa", "new2")),
           ("paired-updated", True, ("taxa",)),
           ("paired-new2", True, ("new2",))]


@pytest.mark.parametrize("case,paired,which", FILTERS,
                         ids=[c for c, _, _ in FILTERS])
def test_filter_reads_equals_jax(base, updated, capsys, case, paired, which):
    """Reads classified by any DB of the list (the DB updated with new
    taxa, the DB of NEW2 alone) are removed, the others kept, mate files
    split alike; files and text equal JAX's."""
    root, dbs, p = base
    r1, r2 = (p["mate1"], p["mate2"]) if paired else (p["reads"], None)
    lists = {who: [updated[f"{who}taxa"] if w == "taxa" else dbs[f"{who}new2"]
                   for w in which] for who in "jt"}
    jtext, jfiles = _filter(jfilter, "j", root, lists["j"], r2, r1, capsys,
                            case)
    ttext, tfiles = _filter(tfilter, "t", root, lists["t"], r2, r1, capsys,
                            case, device="cpu")
    assert ttext == jtext
    assert tfiles == jfiles
    assert len(tfiles) == (4 if paired else 2)
    per = 4 if paired else 2
    n = {kind: sum(b.count(b"\n") for name, b in tfiles.items()
                   if f"_1_{kind}" in name) // per
         for kind in ("removed", "kept")}
    # the updated DB holds write_inputs' genomes and NEW2; NEW1 is in no
    # DB, and the random reads stay too
    want_removed = {"single-end": 18, "paired-updated": 10, "paired-new2": 1}
    assert n["removed"] >= want_removed[case], n
    assert n["kept"] >= (8 if case == "single-end" else 2), n


def test_pack_cache_setting(base, monkeypatch, tmp_path):
    """METABULI_PACK_CACHE=<dir>: the packed layout is cached there and a
    second classifier maps it without packing; "0": a classifier packs
    and nothing is cached (not under HOME either); the records are the
    same under every setting."""
    root, dbs, p = base
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    packs = {"n": 0}
    real = packing.build_aa_hash

    def counted(*a, **k):
        packs["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(packing, "build_aa_hash", counted)
    cache = tmp_path / "cache"
    got = []
    for setting, packed in ((str(cache), 1), (str(cache), 1), ("0", 2)):
        monkeypatch.setenv("METABULI_PACK_CACHE", setting)
        clf = Classifier(dbs["t"], ClassifyParams(**PARAMS), device="cpu")
        assert packs["n"] == packed, setting
        got.append(_records(clf.classify_file(p["reads"])))
        if setting == "0":
            assert packing.cache_root() is None
        else:
            assert packing.cache_root() == str(cache)
            assert len([e for e in os.listdir(cache)
                        if not e.startswith(".")]) == 1
    assert got[0] == got[1] == got[2]
    assert sum(r[1] for r in got[0]) >= 18
    assert not (tmp_path / "home").exists()


def test_update_of_a_reference_format_db(base, tmp_path):
    """A DB of the reference binary (db.parameters and a taxonomyDB blob,
    no db.meta.json) is updated with the parameters its db.parameters
    gives: the reference's extraction, Prodigal's extended ORFs.  Where
    the Prodigal library cannot be built, both packages refuse a diffIdx
    DB with extract_records' message; a deltaIdx.mtbl DB the JAX package
    cannot open at all (ROADMAP Queue 3), the port refuses it alike."""
    root, dbs, p = base
    src = os.path.join(root, "tref_src")
    if not os.path.exists(src):
        tbuilder.build_database(src, p["fastas"], p["acc2taxid"],
                                p["taxdump"], syncmer=True, mask_mode=0,
                                write_reference_format=True)
    index = load_index(src)
    refs = {}
    for layout in ("diffIdx", "mtbl"):
        d = refs[layout] = tmp_path / layout
        d.mkdir()
        shutil.copy(os.path.join(src, "db.parameters"), d)
        write_taxonomy_blob(str(d / "taxonomyDB"), index.taxonomy)
        if layout == "diffIdx":
            for f in ("diffIdx", "info", "split"):
                shutil.copy(os.path.join(src, f), d)
        else:
            encode_metamer_deltas(index.values, index.taxids).astype(
                "<u2").tofile(str(d / "deltaIdx.mtbl"))
        assert load_index(str(d)).meta["gene_predictor"] == "prodigal"
    if tprodigal.available():
        pytest.skip("libprodigal.so builds here")
    msgs = []
    for mod, layout in ((jupdate, "diffIdx"), (tupdate, "diffIdx"),
                        (tupdate, "mtbl")):
        with pytest.raises(RuntimeError) as e:
            mod.update_database(str(refs[layout]), str(tmp_path / "out"),
                                p["fastas2"], p["acc2taxid2"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2]
    assert "gene_predictor='prodigal'" in msgs[0]
    with pytest.raises(FileNotFoundError, match="db.meta.json"):
        jupdate.update_database(str(refs["mtbl"]), str(tmp_path / "jout"),
                                p["fastas2"], p["acc2taxid2"])
