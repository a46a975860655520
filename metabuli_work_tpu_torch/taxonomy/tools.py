"""Taxonomy plumbing utilities.

Reference counterparts in src/util/: editNames.cpp, createnewtaxalist.cpp,
query2reference.cpp, filter_by_genus.cpp, count_common_kmers.cpp.
"""

import os

import numpy as np

from ..index.builder import load_acc2taxid
from ..index.format import load_db_taxonomy
from ..io.fasta import read_fasta
from . import Taxonomy


def edit_names(names_dmp_path, out_path, replacements_path=None):
    """Sanitize names.dmp (GTDB names with problematic characters;
    reference src/util/editNames.cpp): optional replacement TSV
    (old<TAB>new), plus stripping tabs/pipes from name fields."""
    repl = {}
    if replacements_path:
        with open(replacements_path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    repl[parts[0]] = parts[1]
    n = 0
    with open(names_dmp_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            parts = [p.strip() for p in line.rstrip("\t|\n").split("\t|\t")]
            if len(parts) >= 2:
                nm = repl.get(parts[1], parts[1]).replace("|", "_")
                parts[1] = nm
                n += 1
            fout.write("\t|\t".join(parts) + "\t|\n")
    print(f"editNames: {n} rows -> {out_path}")
    return out_path


def create_new_taxa_list(fasta_list_path, acc2taxid, taxdump_dir, out_path):
    """List accessions absent from the taxonomy plus template new-taxa
    rows for updateDB --new-taxa (reference createnewtaxalist.cpp)."""
    tax = Taxonomy.from_taxdump(taxdump_dir)
    mapping = load_acc2taxid(acc2taxid)
    missing = []
    with open(fasta_list_path) as f:
        for fa in (ln.strip() for ln in f if ln.strip()):
            for rec in read_fasta(fa):
                acc = rec.name.split(".")[0]
                tid = mapping.get(acc) or mapping.get(rec.name)
                if tid is None or tax.to_internal(tid) == 0:
                    missing.append((rec.name, tid))
    with open(out_path, "w") as f:
        f.write("#taxid\tparent_taxid\trank\tname\t(accession)\n")
        base = int(tax.int2orig.max()) + 1
        for i, (acc, tid) in enumerate(missing):
            f.write(f"{base + i}\t1\tspecies\t{acc}\t# accession {acc}, old taxid {tid}\n")
    print(f"createnewtaxalist: {len(missing)} unmapped accessions -> {out_path}")
    return missing


def query_to_reference(classifications_path, acc2taxid_path, out_path):
    """Map classified reads back to reference accessions sharing their
    taxid (reference query2reference.cpp)."""
    tax2accs = {}
    with open(acc2taxid_path) as f:
        header = f.readline()
        for line in [header] + f.readlines():
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and parts[2].isdigit():
                tax2accs.setdefault(int(parts[2]), []).append(parts[1] if len(parts) > 1 else parts[0])
    n = 0
    with open(classifications_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or parts[0] != "1":
                continue
            tid = int(parts[2])
            accs = tax2accs.get(tid, [])
            fout.write(f"{parts[1]}\t{tid}\t{','.join(accs) if accs else '-'}\n")
            n += 1
    print(f"query2reference: {n} classified reads -> {out_path}")
    return out_path


def filter_by_genus(classifications_path, db_dir, genus_taxids, out_path):
    """Keep only reads classified under the given genera (reference
    filter_by_genus.cpp)."""
    tax = load_db_taxonomy(db_dir)
    genera = {tax.to_internal(g) for g in genus_taxids} - {0}
    kept = 0
    with open(classifications_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                fout.write(line)
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            try:
                internal = tax.to_internal(int(parts[2]))
            except ValueError:
                continue
            if internal and int(tax.genus_of(internal)) in genera:
                fout.write(line)
                kept += 1
    print(f"filter_by_genus: kept {kept} reads -> {out_path}")
    return out_path


def _distinct(values):
    """np.unique(values), in one pass when they are sorted, as a DB's
    kmers.npy is (np.unique of 36.5 M sorted values took 34.9 s on an
    H100 machine's host, chip_smoke.py)."""
    if len(values) > 1 and bool(np.all(values[1:] >= values[:-1])):
        return values[np.concatenate(([True], values[1:] != values[:-1]))]
    return np.unique(values)


def count_common_kmers(db_dir_a, db_dir_b):
    """Count k-mer values shared between two databases (reference
    count_common_kmers.cpp)."""
    a = np.load(os.path.join(db_dir_a, "kmers.npy"))
    b = np.load(os.path.join(db_dir_b, "kmers.npy"))
    ua = _distinct(a)
    ub = _distinct(b)
    common = len(np.intersect1d(ua, ub, assume_unique=True))
    print(f"count-common-kmers: A={len(ua)} B={len(ub)} shared={common}")
    return common


def make_aa_offset(db_dir, out_path=None):
    """Offsets of each distinct amino-acid part in the sorted index
    (reference makeAAoffset.cpp) — the shard-boundary planning input."""
    values = np.load(os.path.join(db_dir, "kmers.npy"))
    aa = values >> np.uint64(24)
    starts = np.concatenate([[0], np.nonzero(aa[1:] != aa[:-1])[0] + 1]) if len(aa) else np.zeros(0, np.int64)
    out_path = out_path or os.path.join(db_dir, "aa_offsets.npy")
    np.save(out_path, starts.astype(np.int64))
    print(f"makeAAoffset: {len(starts)} AA runs -> {out_path}")
    return starts
