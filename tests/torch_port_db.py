"""Small synthetic databases and reads shared by the tests that hold the
torch package against the JAX package (tests/test_torch_*.py), and the
thread setting every one of those modules takes."""

import os
import shutil

import numpy as np
import pytest
import torch

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, and OMP_NUM_THREADS=1 for the
    processes it starts (the two-process mesh runs, spawned build
    workers); both restored afterwards.  Every tests/test_torch_*.py
    imports this fixture, which makes it autouse there
    (test_torch_isolation.py checks that each does).  The tensors of
    these tests are tiny, and the tier-1 run shares the host's cores
    among several pytest workers: a pool of a thread a core in every
    worker wakes them all for each small operator and only
    oversubscribes the host."""
    n = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def write_inputs(root, seed=0, n_species=4, genome_len=4000):
    """taxdump + one FASTA of n_species genomes (two genera, 3.5%
    within-genus mutations) + fastas.txt + acc2taxid.map under root.
    Returns (genomes, paths dict)."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "taxdump")
    os.makedirs(d, exist_ok=True)
    nodes = ["1\t|\t1\t|\tno rank\t|", "2\t|\t1\t|\tgenus\t|",
             "3\t|\t1\t|\tgenus\t|"]
    names = ["1\t|\troot\t|\t\t|\tscientific name\t|",
             "2\t|\tG1\t|\t\t|\tscientific name\t|",
             "3\t|\tG2\t|\t\t|\tscientific name\t|"]
    for i in range(n_species):
        nodes.append(f"{10 + i}\t|\t{2 + i % 2}\t|\tspecies\t|")
        names.append(f"{10 + i}\t|\tSp{i}\t|\t\t|\tscientific name\t|")
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.write("\n".join(nodes) + "\n")
    with open(os.path.join(d, "names.dmp"), "w") as f:
        f.write("\n".join(names) + "\n")
    open(os.path.join(d, "merged.dmp"), "w").close()
    bases = [ACGT[rng.integers(0, 4, size=genome_len)] for _ in range(2)]
    genomes = []
    fasta = os.path.join(root, "g.fna")
    with open(fasta, "w") as f:
        for i in range(n_species):
            g = bases[i % 2].copy()
            mut = rng.random(genome_len) < 0.035
            g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
            genomes.append(g.tobytes().decode())
            f.write(f">ACC{i}\n{genomes[-1]}\n")
    with open(os.path.join(root, "fastas.txt"), "w") as f:
        f.write(fasta + "\n")
    with open(os.path.join(root, "acc2taxid.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for i in range(n_species):
            f.write(f"ACC{i}\tACC{i}.1\t{10 + i}\t0\n")
    return genomes, {"taxdump": d, "fastas": os.path.join(root, "fastas.txt"),
                     "acc2taxid": os.path.join(root, "acc2taxid.map")}


def build_db(build_database, root, db_name, syncmer, seed=0):
    """Build a DB with the given package's build_database; returns its dir."""
    _, p = write_inputs(root, seed=seed)
    db = os.path.join(root, db_name)
    build_database(db, p["fastas"], p["acc2taxid"], p["taxdump"],
                   syncmer=syncmer, mask_mode=0)
    return db


def simulate_reads(genomes, n, seed=1, read_len=150, err=0.01):
    """Reads drawn from the genomes with errors, half reverse-complemented.
    Returns (reads uint8 [n, read_len], source genome index [n])."""
    rng = np.random.default_rng(seed)
    G = np.stack([np.frombuffer(g.encode(), dtype=np.uint8) for g in genomes])
    gi = rng.integers(0, len(genomes), size=n)
    starts = rng.integers(0, G.shape[1] - read_len, size=n)
    reads = G[gi[:, None], starts[:, None] + np.arange(read_len)[None, :]]
    e = rng.random(reads.shape) < err
    reads[e] = ACGT[rng.integers(0, 4, size=int(e.sum()))]
    rc = rng.random(n) < 0.5
    reads[rc] = _COMP[reads[rc, ::-1]]
    return np.ascontiguousarray(reads), gi


def write_reads(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.tobytes().decode()}\n")


def simulate_pairs(genomes, n, seed=1, read_len=150, insert=(280, 420),
                   err=0.01):
    """Paired reads: mate 1 is the head of a fragment, mate 2 the head of
    its reverse complement; half the fragments come from the other strand.
    Returns (mate1 [n, read_len], mate2 [n, read_len], source genome [n])."""
    rng = np.random.default_rng(seed)
    G = np.stack([np.frombuffer(g.encode(), dtype=np.uint8) for g in genomes])
    gi = rng.integers(0, len(genomes), size=n)
    ins = rng.integers(insert[0], insert[1] + 1, size=n)
    starts = rng.integers(0, G.shape[1] - insert[1], size=n)
    ar = np.arange(read_len)[None, :]
    head = G[gi[:, None], starts[:, None] + ar]
    tail = _COMP[G[gi[:, None], (starts + ins)[:, None] - 1 - ar]]
    flip = rng.random(n) < 0.5
    m1 = np.where(flip[:, None], tail, head)
    m2 = np.where(flip[:, None], head, tail)
    for m in (m1, m2):
        e = rng.random(m.shape) < err
        m[e] = ACGT[rng.integers(0, 4, size=int(e.sum()))]
    return np.ascontiguousarray(m1), np.ascontiguousarray(m2), gi


def simulate_long(genomes, lengths, seed=1, err=0.01, seg=1000):
    """Long reads of the given lengths: each is `seg`-base stretches of
    one genome laid end to end (the genomes are shorter than the reads),
    with errors, half reverse-complemented.  Returns (list of uint8
    arrays, source genome index per read)."""
    rng = np.random.default_rng(seed)
    G = np.stack([np.frombuffer(g.encode(), dtype=np.uint8) for g in genomes])
    reads, src = [], []
    for n in lengths:
        g = int(rng.integers(0, len(genomes)))
        parts = []
        for _ in range(-(-n // seg)):
            s = int(rng.integers(0, G.shape[1] - seg))
            parts.append(G[g, s:s + seg])
        r = np.concatenate(parts)[:n].copy()
        e = rng.random(n) < err
        r[e] = ACGT[rng.integers(0, 4, size=int(e.sum()))]
        if rng.random() < 0.5:
            r = _COMP[r[::-1]]
        reads.append(np.ascontiguousarray(r))
        src.append(g)
    return reads, np.array(src)


def write_taxonomy_blob(path, tax):
    """A reference taxonomyDB blob of `tax` (any object with parent,
    int2orig, rank_of and name_of), in the layout the reference's
    TaxonomyWrapper::serialize writes (version 3, internalTaxIdUsed set,
    so the internal ids are kept): node d holds internal id d + 1; the
    E/L/H/M lookup tables, which a reader skips, are zeros."""
    n = len(tax.parent)
    max_nodes, max_taxid = n - 1, n - 1
    strings, at = [], {}

    def sidx(s):
        if s not in at:
            at[s] = len(strings)
            strings.append(s)
        return at[s]

    node = np.dtype([("id", "<i4"), ("taxId", "<i4"), ("parentTaxId", "<i4"),
                     ("pad", "<i4"), ("rankIdx", "<u8"), ("nameIdx", "<u8")])
    nodes = np.zeros(max_nodes, dtype=node)
    for i in range(1, n):
        nodes[i - 1] = (i - 1, i, int(tax.parent[i]), 0,
                        sidx(tax.rank_of(i)), sidx(tax.name_of(i)))
    D = np.arange(-1, max_nodes, dtype="<i4")
    k = int(np.floor(np.log2(max(2 * max_nodes, 2)))) + 1
    chars = b"".join(s.encode() + b"\0" for s in strings)
    offsets = np.concatenate([[0], np.cumsum([len(s.encode()) + 1
                                              for s in strings])])
    with open(path, "wb") as f:
        for a in (np.array([3], "<i4"), np.array([1, max_nodes], "<u8"),
                  np.array([max_taxid], "<i4"), nodes, D,
                  np.asarray(tax.int2orig, "<i4"),
                  np.zeros(2 * 2 * max_nodes + max_nodes
                           + 2 * max_nodes * k, "<i4"),
                  np.array([len(strings), len(chars)], "<u4"),
                  offsets.astype("<u4")):
            f.write(a.tobytes())
        f.write(chars)


def write_reference_copy(native, d, layout):
    """The native DB directory `native` written in d as a DB of the
    reference binary: its db.parameters, a taxonomyDB blob of its
    taxonomy, no db.meta.json, and diffIdx/info/split (layout "diffIdx",
    the torch package's export) or the 96-bit deltaIdx.mtbl stream
    (layout "mtbl").  Returns d."""
    from metabuli_work_tpu_torch.index import format as tformat
    from metabuli_work_tpu_torch.index.delta import encode_metamer_deltas

    index = tformat.load_index(native)
    os.makedirs(d)
    shutil.copy(os.path.join(native, "db.parameters"), d)
    write_taxonomy_blob(os.path.join(d, "taxonomyDB"), index.taxonomy)
    if layout == "diffIdx":
        tformat.export_reference_format(d, index)
    else:
        encode_metamer_deltas(index.values, index.taxids).astype(
            "<u2").tofile(os.path.join(d, "deltaIdx.mtbl"))
    return d


_STOPS = (b"TAA", b"TAG", b"TGA")
_SENSE = np.array([[a, b, c] for a in b"ACGT" for b in b"ACGT"
                   for c in b"ACGT" if bytes((a, b, c)) not in _STOPS],
                  dtype=np.uint8)


def gene_genome(rng, length, gene_codons=(100, 500), spacer=(50, 300)):
    """A bacterium-like sequence of `length` bases: genes (ATG, stop-free
    random codons, a stop) on either strand between random intergenic
    spacers.  Returns it as a str."""
    parts, n = [], 0
    while n < length:
        sp = int(rng.integers(spacer[0], spacer[1] + 1))
        parts.append(ACGT[rng.integers(0, 4, size=sp)])
        body = _SENSE[rng.integers(0, len(_SENSE),
                                   size=int(rng.integers(*gene_codons)))]
        gene = np.concatenate([np.frombuffer(b"ATG", np.uint8),
                               body.reshape(-1),
                               np.frombuffer(_STOPS[rng.integers(0, 3)],
                                             np.uint8)])
        if rng.random() < 0.5:
            gene = _COMP[gene[::-1]]
        parts.append(gene)
        n += sp + len(gene)
    return np.concatenate(parts)[:length].tobytes().decode()


def write_tool_inputs(d, genomes):
    """Inputs of the taxonomy, report and grading tools, written under
    d["root"] beside write_inputs' files and the DB d["db"] (their paths
    go into d): reads of the genomes plus random reads as FASTA and
    FASTQ; their classification TSV (the torch package's classify on the
    CPU) with a few hand-made rows after it ("cls"; "cls_clean" without
    them); an answer sheet, strata and read groups; a read->taxid
    mapping; GTDB and ICTV taxonomy tables; names.dmp with pipes and a
    replacement table; a FASTA list with accessions missing from the
    taxonomy; an assembly list."""
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.report.reporter import write_classifications

    root = d["root"]
    reads, src = simulate_reads(genomes, 28, seed=42)
    rng = np.random.default_rng(43)
    reads = np.concatenate([reads, ACGT[rng.integers(0, 4, size=(4, 150))]])
    d["reads_fa"] = os.path.join(root, "reads.fna")
    write_reads(d["reads_fa"], reads)
    d["reads_fq"] = os.path.join(root, "reads.fq")
    with open(d["reads_fq"], "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i} c{i % 3}\n{r.tobytes().decode()}\n+\n"
                    f"{'I' * len(r)}\n")
    clf = Classifier(d["db"], ClassifyParams(seq_mode=1, min_score=0.15,
                                             min_sp_score=0.5,
                                             batch_size=16), device="cpu")
    d["cls"] = os.path.join(root, "job_classifications.tsv")
    write_classifications(d["cls"], clf.classify_file(d["reads_fa"]),
                          clf.taxonomy)
    d["cls_clean"] = shutil.copyfile(d["cls"],
                                     os.path.join(root, "clean.tsv"))
    with open(d["cls"], "a") as f:
        f.write("1\tx_unknown\t777\t150\t0.9\tspecies\t777:3 \n"
                "1\tx_bad\tnotanumber\t150\t0.9\tspecies\t\n"
                "0\tx_short\t0\n")
    d["answer"] = os.path.join(root, "answer.tsv")
    with open(d["answer"], "w") as f:
        f.write("#read\ttaxid\n")
        for i, s in enumerate(src):
            f.write(f"r{i}\t{10 + s}\n")
        f.write("r28\t12\nx_unknown\t13\n0\t10\n1\t11\n2\t12\n3\t999\n")
    d["strata"] = os.path.join(root, "strata.tsv")
    with open(d["strata"], "w") as f:
        for i in range(32):
            f.write(f"r{i}\t{'low' if i % 3 else 'high'}\n")
        for i in range(6):
            f.write(f"{i}\t{'low' if i % 2 else 'high'}\n")
    d["groups"] = os.path.join(root, "groups.tsv")
    with open(d["groups"], "w") as f:
        f.write("1\t0\t1\t2\n2\t3\t4\n3\t5\n4\t1\t\t2\n")
    d["mapping"] = os.path.join(root, "mapping.tsv")
    with open(d["mapping"], "w") as f:
        f.write("#read\ttaxid\nr0\t10\nr1\t13\nr2\t2\nr3\t1\nr4\t4242\n")
    d["gtdb1"] = os.path.join(root, "bac.tsv")
    with open(d["gtdb1"], "w") as f:
        f.write("GB_GCA_000001.1\td__Bacteria;p__P1;c__C1;o__O1;f__F1;"
                "g__G1;s__G1 sp1\n"
                "RS_GCF_000002.1\td__Bacteria;p__P1;c__C1;o__O1;f__F1;"
                "g__G1;s__G1 sp2\n"
                "# a comment\n\n"
                "GB_GCA_000003.2\td__Bacteria;p__P2;c__;o__;f__;g__;s__\n")
    d["gtdb2"] = os.path.join(root, "ar.tsv")
    with open(d["gtdb2"], "w") as f:
        f.write("GB_GCA_000004.1\td__Archaea;p__A1;c__AC;o__AO;f__AF;"
                "g__AG;s__AG x\n")
    d["names"] = os.path.join(root, "names.dmp")
    with open(d["names"], "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n"
                "2\t|\tG|1\t|\t\t|\tscientific name\t|\n"
                "10\t|\tSp0\t|\t\t|\tscientific name\t|\n"
                "11\t|\told name\t|\t\t|\tsynonym\t|\n")
    d["repl"] = os.path.join(root, "repl.tsv")
    with open(d["repl"], "w") as f:
        f.write("Sp0\tSpecies zero\nold name\tnew|name\n")
    d["fastas_new"] = os.path.join(root, "fastas_new.txt")
    with open(os.path.join(root, "new.fna"), "w") as f:
        f.write(">ACC1.1\nACGT\n>NEWACC.1 x\nACGT\n>ACC2\nACGT\n"
                ">LOST.3\nACGT\n")
    with open(d["fastas_new"], "w") as f:
        f.write(os.path.join(root, "new.fna") + "\n")
    d["acc2taxid_new"] = os.path.join(root, "new.map")
    with open(d["acc2taxid_new"], "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n"
                "ACC1\tACC1.1\t11\t0\nACC2\tACC2.1\t12\t0\n"
                "LOST\tLOST.3\t4242\t0\n")
    d["assemblies"] = os.path.join(root, "assemblies.tsv")
    with open(d["assemblies"], "w") as f:
        for i, t in enumerate([10, 11, 12, 13, 10, 12, 4242, 2]):
            f.write(f"asm{i}.fna\t{t}\n")
    d["ictv"] = os.path.join(root, "ictv.tsv")
    with open(d["ictv"], "w") as f:
        f.write("Sort\tRealm\tKingdom\tOrder\tFamily\tGenus\tSpecies\n"
                "1\tRiboviria\tOrthornavirae\tO1\tF1\tGa\tGa one\n"
                "2\tRiboviria\tOrthornavirae\tO1\tF1\tGa\tGa two\n"
                "3\tRiboviria\tOrthornavirae\tO1\tF2\tGb\tGb one\n"
                "4\tRiboviria\t\tO2\tF3\tGc\tGc one\n"
                "5\tRiboviria\tOrthornavirae\tO1\tF1\tGd\tGd one\n")
