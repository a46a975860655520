"""ORF and CDS builds of the torch package against the JAX package: the
heuristic ORF scan (index/orf.py), the min-hash strand check
(index/minhash.py), the Prodigal binding's availability and its
block-stitching logic (index/prodigal.py, under one stand-in xxh64 in
both packages), and build_database with orf_prediction (the heuristic
predictor and 'auto'), with --cds-info spans (GFF3 and TSV) and with
threads=2 against threads=1, exactly: the same blocks, arrays, bytes
and printed text; and a CPU classify on the ORF DB."""

import hashlib
import os

import numpy as np
import pytest

from metabuli_work_tpu.index import builder as jbuilder
from metabuli_work_tpu.index import minhash as jminhash
from metabuli_work_tpu.index import orf as jorf
from metabuli_work_tpu.index import prodigal as jprodigal
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import builder as tbuilder
from metabuli_work_tpu_torch.index import minhash as tminhash
from metabuli_work_tpu_torch.index import orf as torf
from metabuli_work_tpu_torch.index import prodigal as tprodigal

from torch_port_db import (ACGT, gene_genome, simulate_reads, write_inputs,
                           write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)


def _seq(case):
    rng = np.random.default_rng(len(case))
    if case == "random":
        return ACGT[rng.integers(0, 4, size=3000)].tobytes().decode()
    if case == "genes":
        return gene_genome(rng, 6000)
    if case == "genes-with-N":
        s = bytearray(gene_genome(rng, 5000).encode())
        for at in rng.integers(0, len(s), size=40):
            s[at] = ord("N")
        return s.decode()
    if case == "short":
        return "ATGAAATTTGGGTAA" * 3
    raise KeyError(case)


SEQ_CASES = ["random", "genes", "genes-with-N", "short"]


@pytest.mark.parametrize("case", SEQ_CASES)
@pytest.mark.parametrize("min_gene,extend", [(90, 22), (150, 30)])
def test_predict_orfs_equals_jax(case, min_gene, extend):
    seq = _seq(case)
    got = torf.predict_orfs(seq, min_gene=min_gene, extend=extend)
    assert got == jorf.predict_orfs(seq, min_gene=min_gene, extend=extend)
    if case.startswith("genes"):
        assert len(got) > 5


@pytest.mark.parametrize("case", SEQ_CASES)
def test_minhash_equals_jax(case):
    seq = _seq(case)
    sk = tminhash.minhash_sketch(seq)
    np.testing.assert_array_equal(sk, jminhash.minhash_sketch(seq))
    assert sk.dtype == np.uint64
    half = seq[: len(seq) // 2]
    rc = tprodigal.reverse_complement(seq)
    assert rc == jprodigal.reverse_complement(seq)
    for other in (seq, half, rc):
        osk = tminhash.minhash_sketch(other)
        assert tminhash.minhash_similar(sk, osk, len(seq), len(other)) == \
            jminhash.minhash_similar(sk, osk, len(seq), len(other))
        assert tminhash.same_strand(seq, other) == \
            jminhash.same_strand(seq, other)


def test_prodigal_available_equals_jax():
    assert tprodigal.available() == jprodigal.available()
    if not tprodigal.available():
        assert tprodigal.unavailable_reason()
        with pytest.raises(RuntimeError):
            tprodigal.ProdigalRunner()


def _stand_in_xxh64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


def _gene_calls(rng, length, n):
    """n sorted gene calls (1-based inclusive begin/end, strand +-1);
    some genes start exactly 24 bases after the previous one ends, so
    the intergenic 23-mer before them is the one after that gene."""
    begins, ends, strands = [], [], []
    at = int(rng.integers(1, 60))
    for _ in range(n):
        b = at
        e = b + int(rng.integers(30, 300)) * 3 - 1
        if e > length:
            break
        begins.append(b)
        ends.append(e)
        strands.append(1 if rng.random() < 0.5 else -1)
        at = e + (24 if rng.random() < 0.4 else int(rng.integers(1, 120)))
    return (np.array(begins, np.int32), np.array(ends, np.int32),
            np.array(strands, np.int32))


@pytest.mark.parametrize("n_genes", [0, 1, 2, 3, 12, 40])
def test_extended_orfs_equal_jax(monkeypatch, n_genes):
    """generate_intergenic_kmer_list on a training sequence's calls, then
    get_extended_orfs over three sequences of the species (the training
    sequence, a copy with new calls, and a stranger), the intergenic
    list mutated across them: the same blocks and lists."""
    monkeypatch.setattr(jprodigal, "xxh64", _stand_in_xxh64)
    monkeypatch.setattr(tprodigal, "xxh64", _stand_in_xxh64)
    rng = np.random.default_rng(n_genes)
    train = gene_genome(rng, 20_000)
    calls = _gene_calls(rng, len(train), n_genes)
    lists = {}
    for name, mod in (("j", jprodigal), ("t", tprodigal)):
        lists[name] = mod.generate_intergenic_kmer_list(*calls, train)
    assert lists["t"] == lists["j"]
    others = [(train, calls), (train, _gene_calls(rng, len(train), n_genes)),
              (gene_genome(rng, 12_000), None)]
    hits = 0
    for seq, c in others:
        c = c or _gene_calls(rng, len(seq), n_genes)
        before = list(lists["t"])
        got = tprodigal.get_extended_orfs(*c, len(seq), lists["t"], seq)
        assert got == jprodigal.get_extended_orfs(*c, len(seq), lists["j"],
                                                  seq)
        assert lists["t"] == lists["j"]
        hits += len(lists["t"]) < len(before) + max(n_genes - 1, 0)
    if n_genes >= 12:
        assert hits, "no gene found its left flank in the intergenic list"


# ------------------------------------------------------------- the builds
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The taxdump and acc2taxid of write_inputs over four gene-structured
    genomes (two genera, 3.5% mutations), CDS spans of three accessions
    as GFF3 and as TSV, and reads of the genomes."""
    root = str(tmp_path_factory.mktemp("orf"))
    _, p = write_inputs(root)
    rng = np.random.default_rng(11)
    bases = [np.frombuffer(gene_genome(rng, 4000).encode(), np.uint8)
             for _ in range(2)]
    genomes = []
    with open(os.path.join(root, "g.fna"), "w") as f:
        for i in range(4):
            g = bases[i % 2].copy()
            mut = rng.random(len(g)) < 0.035
            g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
            genomes.append(g.tobytes().decode())
            f.write(f">ACC{i}.1\n{genomes[-1]}\n")
    spans = {f"ACC{i}": [(int(s), int(s) + int(n) - 1,
                          "+" if rng.random() < 0.5 else "-")
                         for s, n in zip(rng.integers(1, 3000, size=6),
                                         rng.integers(60, 900, size=6))]
             for i in range(3)}
    p["gff3"] = os.path.join(root, "cds.gff3")
    with open(p["gff3"], "w") as f:
        f.write("##gff-version 3\n")
        for acc, ss in spans.items():
            for k, (s, e, st) in enumerate(ss):
                f.write(f"{acc}.1\tsim\tCDS\t{s}\t{e}\t.\t{st}\t0\tID=c{k}\n")
                f.write(f"{acc}.1\tsim\tgene\t{s}\t{e}\t.\t{st}\t.\tID=g{k}\n")
    p["tsv"] = os.path.join(root, "cds.tsv")
    with open(p["tsv"], "w") as f:
        for acc, ss in spans.items():
            for s, e, st in ss:
                f.write(f"{acc}.1\t{s}\t{e}\t{st}\n")
    reads, p["src"] = simulate_reads(genomes, 24, seed=12)
    p["reads"] = os.path.join(root, "reads.fna")
    write_reads(p["reads"], reads)
    return root, p


BUILDS = {
    "heuristic": dict(orf_prediction=True, gene_predictor="heuristic"),
    "auto": dict(orf_prediction=True),
    "cds-gff3": dict(cds_info_path="gff3"),
    "cds-tsv": dict(cds_info_path="tsv"),
    "cds-gff3-and-orf": dict(cds_info_path="gff3", orf_prediction=True),
    "threads2": dict(orf_prediction=True, threads=2),
}


def _build(mod, root, p, name, kw, capsys):
    kw = dict(kw)
    if "cds_info_path" in kw:
        kw["cds_info_path"] = p[kw["cds_info_path"]]
    capsys.readouterr()
    db = os.path.join(root, name)
    index = mod.build_database(db, p["fastas"], p["acc2taxid"], p["taxdump"],
                               syncmer=True, mask_mode=0, **kw)
    return db, index, capsys.readouterr().out


@pytest.mark.parametrize("case", list(BUILDS))
def test_orf_and_cds_builds_equal_jax(inputs, capsys, case):
    root, p = inputs
    jdb, jidx, jout = _build(jbuilder, root, p, f"j_{case}", BUILDS[case],
                             capsys)
    tdb, tidx, tout = _build(tbuilder, root, p, f"t_{case}", BUILDS[case],
                             capsys)
    assert tout == jout
    for k in ("values", "taxids", "species"):
        np.testing.assert_array_equal(getattr(tidx, k), getattr(jidx, k))
    for k in ("orf_prediction", "gene_predictor"):
        assert tidx.meta[k] == jidx.meta[k]
    for f in ("kmers.npy", "infos.npy", "species.npy", "taxID_list",
              "acc2taxid.map"):
        with open(os.path.join(jdb, f), "rb") as a, \
                open(os.path.join(tdb, f), "rb") as b:
            assert a.read() == b.read(), f
    if case != "threads2":
        return
    # threads=2 (spawned extraction workers) equals threads=1
    _, one, _ = _build(tbuilder, root, p, "t_threads1",
                       dict(orf_prediction=True), capsys)
    np.testing.assert_array_equal(tidx.values, one.values)
    np.testing.assert_array_equal(tidx.taxids, one.taxids)
    full = tbuilder.build_database(os.path.join(root, "t_six"), p["fastas"],
                                   p["acc2taxid"], p["taxdump"],
                                   syncmer=True, mask_mode=0)
    assert 0 < one.size < full.size


def test_prodigal_predictor_refusal_equals_jax(inputs):
    root, p = inputs
    if tprodigal.available():
        pytest.skip("libprodigal.so builds here")
    msgs = []
    for mod, name in ((jbuilder, "j_prod"), (tbuilder, "t_prod")):
        with pytest.raises(RuntimeError) as e:
            mod.build_database(os.path.join(root, name), p["fastas"],
                               p["acc2taxid"], p["taxdump"], mask_mode=0,
                               orf_prediction=True, gene_predictor="prodigal")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "gene_predictor='heuristic'" in msgs[0]


def test_orf_db_classifies(inputs):
    """A CPU classify on the ORF DB (whose files equal JAX's above) calls
    the reads of the genomes at their species or genus."""
    root, p = inputs
    db = os.path.join(root, "t_classify")
    tbuilder.build_database(db, p["fastas"], p["acc2taxid"], p["taxdump"],
                            syncmer=True, mask_mode=0, orf_prediction=True)
    clf = Classifier(db, ClassifyParams(**PARAMS), device="cpu")
    got = clf.classify_file(p["reads"])
    right = [clf.taxonomy.orig_of(q.result.classification)
             in (10 + s, 2 + s % 2) for q, s in zip(got, p["src"])]
    assert sum(right) >= 20, right
