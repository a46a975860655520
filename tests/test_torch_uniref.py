"""The UniRef tools in the torch package vs the JAX package's, on the
CPU, exact (file bytes, array values and order): extract_protein_kmers
on random proteins with the '*', 'X' and gap codes, with and without
syncmer; the cluster tree from XML; the unique-k-mer and UniRef DB
files (the meta without its date); the assign_uniref TSV, including a
tie that the tree LCA resolves; uniref2taxonomy; and the five CLI
subcommands through cli.main in process."""

import json
import os

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu.ops.encode_aa import extract_protein_kmers as jextract
from metabuli_work_tpu.uniref import classifier as jclassifier
from metabuli_work_tpu.uniref import db as jdb
from metabuli_work_tpu.uniref.tree import UnirefTree as JTree
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.ops.encode_aa import extract_protein_kmers
from metabuli_work_tpu_torch.uniref import classifier as tclassifier
from metabuli_work_tpu_torch.uniref import db as tdb
from metabuli_work_tpu_torch.uniref.tree import UnirefTree

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

AA = np.array(list("ARNDCQEGHILKMFPSTWYV"))


def _mutate(rng, p, rate):
    p = np.array(list(p))
    m = rng.random(len(p)) < rate
    p[m] = rng.choice(AA, size=int(m.sum()))
    return "".join(p)


@pytest.fixture(scope="module")
def uniref(tmp_path_factory):
    """Two UniRef50 clusters of two UniRef90 clusters of two or three
    UniRef100 clusters; the proteins of a UniRef90 cluster are mutants of
    one ancestor.  Queries: copies, mutants, a tie of two sibling
    clusters' halves, random proteins and one with stop and gap codes."""
    root = str(tmp_path_factory.mktemp("uniref"))
    rng = np.random.default_rng(81)
    entries, prots = [], {}
    for a in range(2):
        for b in range(2):
            anc = "".join(rng.choice(AA, size=int(rng.integers(90, 160))))
            for c in range(2 + (a + b) % 2):
                u100 = f"UniRef100_P{a}{b}{c}"
                entries.append((u100, f"UniRef90_P{a}{b}", f"UniRef50_P{a}"))
                prots[u100] = _mutate(rng, anc, 0.08)
    with open(os.path.join(root, "uniref.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<UniRef100 xmlns="http://uniprot.org/uniref">\n')
        for u100, u90, u50 in entries:
            f.write(f'<entry id="{u100}">\n'
                    f'  <property type="UniRef90 ID" value="{u90}"/>\n'
                    f'  <property type="UniRef50 ID" value="{u50}"/>\n'
                    f'</entry>\n')
        f.write("</UniRef100>\n")
    with open(os.path.join(root, "proteins.faa"), "w") as f:
        for name, p in prots.items():
            f.write(f">{name}\n{p}\n")
        f.write(">P999_unclustered\n" + "".join(rng.choice(AA, size=80))
                + "\n")
    names = list(prots)
    queries = [(n + "_copy", prots[n]) for n in names[:4]]
    queries += [(n + "_mut", _mutate(rng, prots[n], 0.05)) for n in names[3:]]
    # a tie: equal halves of two UniRef100 siblings of different
    # ancestors -> their UniRef50 (tree LCA)
    queries.append(("tie", prots[names[0]][:40] + prots[names[2]][:40]))
    queries.append(("random", "".join(rng.choice(AA, size=100))))
    queries.append(("codes", prots[names[1]][:30] + "*X-" + prots[names[1]][30:]))
    with open(os.path.join(root, "queries.faa"), "w") as f:
        for n, p in queries:
            f.write(f">{n}\n{p}\n")
    with open(os.path.join(root, "cluster2taxid.tsv"), "w") as f:
        for i, (u100, u90, u50) in enumerate(entries):
            f.write(f"{u100}\t{100 + i}\n{u90}\t{200 + i // 2}\n")
    return root


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("syncmer", [False, True], ids=["plain", "syncmer"])
def test_protein_kmers_match_jax(syncmer):
    rng = np.random.default_rng(82 + syncmer)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYVBZUOXarnd*-.?" * 3
                            + "ARNDCQEGHILKMFPSTWYV" * 12))
    for n in (5, 12, 13, 40, 200):
        seq = "".join(rng.choice(letters, size=n))
        ref = jextract(seq, k=12, syncmer=syncmer)
        got = extract_protein_kmers(seq, k=12, syncmer=syncmer)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    seq = "".join(rng.choice(AA, size=300))
    assert len(extract_protein_kmers(seq, syncmer=syncmer)[0]) > 50


def test_tree_from_xml_matches_jax(uniref, tmp_path):
    xml = os.path.join(uniref, "uniref.xml")
    ref, got = JTree.from_xml(xml), UnirefTree.from_xml(xml)
    assert got.names == ref.names
    np.testing.assert_array_equal(got.parent, ref.parent)
    path = str(tmp_path / "t.npz")
    got.save(path)
    back = UnirefTree.load(path)
    assert back.names == ref.names and back.name2id == ref.name2id
    ids = list(range(len(ref)))
    for a in ids:
        assert got.name_of(a) == ref.name_of(a)
        for b in ids:
            assert got.lca_pair(a, b) == ref.lca_pair(a, b)
            assert got.is_ancestor(a, b) == ref.is_ancestor(a, b)
    assert got.lca_list(ids[4:9]) == ref.lca_list(ids[4:9])
    assert got.name_of(len(ref)) == "-"


def _meta(d):
    with open(os.path.join(d, "db.meta.json")) as f:
        m = json.load(f)
    m.pop("creation_date")
    return m


@pytest.mark.parametrize("syncmer", [False, True], ids=["plain", "syncmer"])
def test_uniref_dbs_and_assign_match_jax(uniref, tmp_path, syncmer):
    faa = os.path.join(uniref, "proteins.faa")
    tree = str(tmp_path / "tree.npz")
    UnirefTree.from_xml(os.path.join(uniref, "uniref.xml")).save(tree)
    files = {}
    for tag, db, clf in (("j", jdb, jclassifier), ("t", tdb, tclassifier)):
        u = str(tmp_path / tag / "unique")
        db.build_unique_kmer_db(u, faa, syncmer=syncmer)
        d = str(tmp_path / tag / "uniref")
        db.build_uniref_db(d, faa, tree, syncmer=syncmer)
        out = clf.assign_uniref(os.path.join(uniref, "queries.faa"), d,
                                str(tmp_path / tag / "out"))
        files[tag] = {"tsv": _read(out), "meta": _meta(d),
                      "umeta": _meta(u),
                      "names": _read(os.path.join(u, "seq_names.tsv"))}
        for sub in (u, d):
            for name in ("kmers.npy", "infos.npy"):
                files[tag][sub[-7:] + name] = np.load(os.path.join(sub, name))
        files[tag]["tree"] = UnirefTree.load(os.path.join(d,
                                                          "uniref_tree.npz"))
    j, t = files["j"], files["t"]
    for key in j:
        if key == "tree":
            assert t[key].names == j[key].names
            np.testing.assert_array_equal(t[key].parent, j[key].parent)
        elif isinstance(j[key], np.ndarray):
            assert t[key].dtype == j[key].dtype
            np.testing.assert_array_equal(t[key], j[key])
        else:
            assert t[key] == j[key], key
    rows = [ln.split("\t") for ln in t["tsv"].decode().splitlines()[1:]]
    by = {r[1]: r for r in rows}
    tr = t["tree"]
    for r in rows:
        if r[1].endswith("_copy"):      # its own cluster or an ancestor
            assert tr.is_ancestor(int(r[2]), tr.name2id[r[1][:-5]]), r
    if not syncmer:
        assert by["tie"][3] == "UniRef50_P0"        # LCA of the tied pair
        assert by["random"][2] == "0"


def test_uniref_cli_matches_jax(uniref, tmp_path, capsys):
    files = {}
    for tag, cli in (("j", jcli), ("t", tcli)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        assert cli.main(["create-uniref-tree",
                         os.path.join(uniref, "uniref.xml"),
                         d + "/tree.npz"]) == 0
        assert cli.main(["create-uniref-db", d + "/db",
                         os.path.join(uniref, "proteins.faa"),
                         d + "/tree.npz"]) == 0
        assert cli.main(["create-unique-kmer-list", d + "/uniq",
                         os.path.join(uniref, "proteins.faa"),
                         "--syncmer", "1"]) == 0
        assert cli.main(["assign_uniref", os.path.join(uniref, "queries.faa"),
                         d + "/db", d + "/out"]) == 0
        assert cli.main(["uniref2taxonomy",
                         d + "/out/uniref_classifications.tsv",
                         os.path.join(uniref, "cluster2taxid.tsv"),
                         d + "/tax.tsv"]) == 0
        files[tag] = {n: _read(os.path.join(d, n)) for n in (
            "db/kmers.npy", "db/infos.npy", "uniq/kmers.npy",
            "uniq/infos.npy", "uniq/seq_names.tsv",
            "out/uniref_classifications.tsv", "tax.tsv")}
        t = UnirefTree.load(d + "/tree.npz")
        files[tag]["tree"] = (t.names, t.parent.tolist())
    assert files["t"] == files["j"]
    assert files["t"]["tax.tsv"].count(b"\n") == 15
