"""GTDB taxonomy -> NCBI-style taxdump converter.

Reference: util/gtdb_to_taxdump/ (Python package gtdb2td) +
util/prepare_gtdb_taxonomy.sh: parse GTDB bacterial/archaeal taxonomy
TSVs (accession<TAB>d__...;p__...;c__...;o__...;f__...;g__...;s__...)
into nodes.dmp/names.dmp/merged.dmp plus an accession2taxid mapping so
GTDB databases build exactly like NCBI-taxonomy ones.
"""

import os

_RANKS = [
    ("d__", "superkingdom"),
    ("p__", "phylum"),
    ("c__", "class"),
    ("o__", "order"),
    ("f__", "family"),
    ("g__", "genus"),
    ("s__", "species"),
]


def gtdb_to_taxdump(tsv_paths, out_dir, start_taxid: int = 10000000):
    """Convert GTDB taxonomy TSV(s) to a taxdump directory.

    Returns the accession->taxid mapping (assemblies get leaf ids under
    their species).
    """
    os.makedirs(out_dir, exist_ok=True)
    next_id = start_taxid
    node_of = {}          # lineage-prefix tuple -> taxid
    parent = {1: 1}
    rank = {1: "no rank"}
    name = {1: "root"}
    acc2taxid = {}

    def new_node(par, rk, nm):
        nonlocal next_id
        tid = next_id
        next_id += 1
        parent[tid] = par
        rank[tid] = rk
        name[tid] = nm
        return tid

    for tsv in tsv_paths:
        with open(tsv) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                acc, lineage = line.rstrip("\n").split("\t")[:2]
                par = 1
                prefix = []
                for tag, rk in _RANKS:
                    part = next((p for p in lineage.split(";") if p.startswith(tag)), None)
                    if part is None or part == tag:
                        break
                    prefix.append(part)
                    key = tuple(prefix)
                    if key not in node_of:
                        node_of[key] = new_node(par, rk, part[3:])
                    par = node_of[key]
                # assembly leaf under the species
                leaf = new_node(par, "no rank", acc)
                acc2taxid[acc] = leaf

    with open(os.path.join(out_dir, "nodes.dmp"), "w") as f:
        for tid in sorted(parent):
            f.write(f"{tid}\t|\t{parent[tid]}\t|\t{rank[tid]}\t|\n")
    with open(os.path.join(out_dir, "names.dmp"), "w") as f:
        for tid in sorted(parent):
            f.write(f"{tid}\t|\t{name[tid]}\t|\t\t|\tscientific name\t|\n")
    open(os.path.join(out_dir, "merged.dmp"), "w").close()
    with open(os.path.join(out_dir, "gtdb_acc2taxid.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for acc, tid in acc2taxid.items():
            base = acc.split(".")[0]
            f.write(f"{base}\t{acc}\t{tid}\t0\n")
    print(f"gtdb2taxdump: {len(parent) - 1} taxa, {len(acc2taxid)} assemblies -> {out_dir}")
    return acc2taxid
