"""Read grouping in the torch package vs the JAX package's, on the CPU,
exact (file bytes, array values and order): the common-k-mer DB
(kmers.npy, infos.npy, the meta without its date), `groups` and
`groupMap` of single and paired reads with and without the common-k-mer
filter and with --neighbor-kmers 0 and 2, the pair weights under a
spill budget that spills, the native union-find against the Python
DisjointSet (its plain version) and the JAX package's, `apply-group`
output in weight modes 0-2, and the three CLI subcommands through
cli.main in process."""

import json
import os

import numpy as np
import pytest

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu.index.common import build_common_kmer_db as jcommon
from metabuli_work_tpu.readgroup import apply as japply
from metabuli_work_tpu.readgroup import grouping as jgroup
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.index.common import build_common_kmer_db
from metabuli_work_tpu_torch.readgroup import apply as tapply
from metabuli_work_tpu_torch.readgroup import grouping as tgroup

from torch_port_db import simulate_pairs, simulate_reads, write_inputs, \
    write_reads
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rg"))
    genomes, paths = write_inputs(root)
    reads, src = simulate_reads(genomes, 160, seed=71)
    write_reads(os.path.join(root, "reads.fna"), reads)
    m1, m2, _ = simulate_pairs(genomes, 80, seed=72)
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2[:, :141])
    # classifications of the single-end reads: mostly the source
    # species, some at the genus, some unclassified, a few wrong
    rng = np.random.default_rng(73)
    with open(os.path.join(root, "cls.tsv"), "w") as f:
        f.write("#is_classified\tname\ttaxID\tquery_length\tscore\trank\t"
                "taxID:match_count\n")
        for i, g in enumerate(src):
            u = rng.random()
            tid = 0 if u < 0.15 else 2 + g % 2 if u < 0.3 else \
                10 + (g + 1) % 4 if u < 0.35 else 10 + g
            score = round(float(rng.uniform(0.05, 1.0)), 3)
            if tid:
                f.write(f"1\tr{i}\t{tid}\t150\t{score}\tspecies\t{tid}:5 \n")
            else:
                f.write(f"0\tr{i}\t0\t150\t0\t-\t-\t\n")
    for name, build in (("jcommon", jcommon), ("tcommon", build_common_kmer_db)):
        build(os.path.join(root, name), paths["fastas"], paths["acc2taxid"],
              paths["taxdump"], common_filter="always")
    return dict(root=root, paths=paths, genomes=genomes)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _meta(d):
    with open(os.path.join(d, "db.meta.json")) as f:
        m = json.load(f)
    m.pop("creation_date")
    return m


@pytest.mark.parametrize("common_filter", ["auto", "always"])
def test_common_kmer_db_matches_jax(data, tmp_path, common_filter):
    p = data["paths"]
    if common_filter == "always":
        jd, td = (os.path.join(data["root"], n) for n in ("jcommon",
                                                          "tcommon"))
    else:
        jd, td = str(tmp_path / "j"), str(tmp_path / "t")
        for d, build in ((jd, jcommon), (td, build_common_kmer_db)):
            build(d, p["fastas"], p["acc2taxid"], p["taxdump"])
    for name in ("kmers.npy", "infos.npy"):
        a, b = np.load(os.path.join(jd, name)), np.load(os.path.join(td, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert _meta(jd) == _meta(td)
    n = len(np.load(os.path.join(td, "kmers.npy")))
    assert n > (100 if common_filter == "always" else 1000)


@pytest.mark.parametrize("mode,neighbor,common", [
    (1, 0, True), (1, 2, True), (1, 0, False), (2, 0, True), (2, 2, False)],
    ids=["single", "single-neighbor2", "single-nofilter", "paired",
         "paired-neighbor2-nofilter"])
def test_grouping_matches_jax(data, tmp_path, capsys, mode, neighbor, common):
    root = data["root"]
    r1 = os.path.join(root, "reads.fna" if mode == 1 else "r1.fna")
    r2 = os.path.join(root, "r2.fna") if mode == 2 else None
    kw = dict(seq_mode=mode, neighbor_kmers=neighbor, num_iterations=4)
    out = {}
    for tag, mod in (("j", jgroup), ("t", tgroup)):
        cdb = os.path.join(root, tag + "common") if common else "-"
        d = str(tmp_path / tag)
        out[tag] = mod.run_grouping(r1, cdb, d, mod.GroupingParams(**kw), r2)
        for name in ("groups", "groupMap"):
            out[tag, name] = _read(os.path.join(d, name))
    np.testing.assert_array_equal(out["j"], out["t"])
    assert out["j", "groups"] == out["t", "groups"]
    assert out["j", "groupMap"] == out["t", "groupMap"]
    assert (out["t"] > 0).sum() >= 20          # some reads are grouped
    assert "union-find native" in capsys.readouterr().out


def test_pair_weights_spill_matches_jax(data):
    reads = [g[s:s + 150] for g in data["genomes"] for s in range(0, 900, 30)]
    params = tgroup.GroupingParams()
    k, r, _ = tgroup.extract_read_kmers(reads, params)
    jk, jr, _ = jgroup.extract_read_kmers(reads, jgroup.GroupingParams())
    np.testing.assert_array_equal(k, jk)
    ram = tgroup.build_pair_weights(k, r)
    for budget in (64, 1000):
        got = tgroup.build_pair_weights(k, r, budget_rows=budget)
        ref = jgroup.build_pair_weights(jk, jr, budget_rows=budget)
        for a, b, c in zip(got, ref, ram):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    acc = tgroup.SortedRunAccumulator(budget_rows=32)
    keys = np.arange(300)[::-1] % 97
    for i in range(0, 300, 30):
        acc.add(keys[i:i + 30], np.ones(30, np.int64))
    keys, cnt = acc.finalize()
    assert acc.spilled_runs >= 4
    np.testing.assert_array_equal(keys, np.arange(97))
    np.testing.assert_array_equal(cnt, np.bincount(np.arange(300) % 97))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_union_find_equals_disjoint_set(seed):
    rng = np.random.default_rng(seed)
    n = 400
    id1 = rng.integers(1, n + 1, size=900)
    id2 = rng.integers(1, n + 1, size=900)
    w = rng.integers(0, 30, size=900)
    keep = w > 10
    native = tgroup.make_groups(id1, id2, w, n, keep)
    plain = tgroup.make_groups(id1, id2, w, n, keep, native=False)
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native,
                                  jgroup.make_groups(id1, id2, w, n, keep))
    assert len(set(native[native > 0].tolist())) > 1


@pytest.mark.parametrize("weight_mode", [0, 1, 2])
def test_apply_group_matches_jax(data, tmp_path, weight_mode):
    root = data["root"]
    gd = str(tmp_path / "groups")
    tgroup.run_grouping(os.path.join(root, "reads.fna"), "-", gd,
                        tgroup.GroupingParams(num_iterations=4))
    args = (os.path.join(gd, "groups"), os.path.join(gd, "groupMap"),
            data["paths"]["taxdump"], os.path.join(root, "cls.tsv"))
    files = {}
    for tag, mod in (("j", japply), ("t", tapply)):
        out = str(tmp_path / tag)
        mod.apply_groups(*args, out, mod.ApplyParams(weight_mode=weight_mode))
        for name in ("groupRep", "updated_classifications.tsv"):
            files[tag, name] = _read(os.path.join(out, name))
    for name in ("groupRep", "updated_classifications.tsv"):
        assert files["t", name] == files["j", name], name
    assert files["t", "groupRep"].strip()


def test_readgroup_cli_matches_jax(data, tmp_path, capsys):
    root, p = data["root"], data["paths"]
    files = {}
    for tag, cli in (("j", jcli), ("t", tcli)):
        d = str(tmp_path / tag)
        assert cli.main(["create-common-kmer-list", d + "/common",
                         p["fastas"], p["acc2taxid"], "--taxonomy-dir",
                         p["taxdump"]]) == 0
        assert cli.main(["grouping", os.path.join(root, "r1.fna"),
                         os.path.join(root, "r2.fna"), d + "/common",
                         d + "/grp", "--seq-mode", "2", "--num-iteration",
                         "4", "--min-edge", "8"]) == 0
        assert cli.main(["apply-group", d + "/grp/groups", d + "/grp/groupMap",
                         d + "/common", os.path.join(root, "cls.tsv"),
                         d + "/app", "--weight-mode", "2",
                         "--min-vote-score", "0.3"]) == 0
        for name in ("common/kmers.npy", "common/infos.npy", "grp/groups",
                     "grp/groupMap", "app/groupRep",
                     "app/updated_classifications.tsv"):
            files[tag, name] = _read(os.path.join(d, name))
    for (tag, name), b in files.items():
        if tag == "t":
            assert b == files["j", name], name
    assert files["t", "grp/groups"]
