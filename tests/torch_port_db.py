"""Small synthetic databases and reads shared by the tests that hold the
torch package against the JAX package (tests/test_torch_*.py)."""

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
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
