"""Virus benchmark set construction + ICTV formatting.

Reference: src/benchmark/makeVirusBenchmarkSet.cpp (rank-stratified
virus exclusion sets using ICTV ranks) and src/util/ictv-format
(ictvFormat.cpp): convert an ICTV Master Species List-style TSV into
taxdump files whose ranks follow the ICTV hierarchy.
"""

import os
import random
from collections import defaultdict

from ..index.format import load_db_taxonomy
from .benchmark import load_assembly_list

ICTV_RANKS = [
    "realm", "subrealm", "kingdom", "subkingdom", "phylum", "subphylum",
    "class", "subclass", "order", "suborder", "family", "subfamily",
    "genus", "subgenus", "species",
]


def ictv_format(tsv_path, out_dir, start_taxid: int = 20000000):
    """ICTV TSV (columns named after ranks, + 'Virus name'/species) ->
    taxdump.  Empty rank cells skip levels."""
    os.makedirs(out_dir, exist_ok=True)
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
    cols = {h.strip().lower(): i for i, h in enumerate(header)}
    rank_cols = [(r, cols[r]) for r in ICTV_RANKS if r in cols]
    if not rank_cols:
        raise SystemExit("no ICTV rank columns found in header")

    next_id = start_taxid
    parent = {1: 1}
    rank = {1: "no rank"}
    name = {1: "root"}
    node_of = {}

    def new_node(par, rk, nm):
        nonlocal next_id
        tid = next_id
        next_id += 1
        parent[tid], rank[tid], name[tid] = par, rk, nm
        return tid

    n_rows = 0
    with open(tsv_path) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            par = 1
            prefix = []
            for rk, ci in rank_cols:
                val = parts[ci].strip() if ci < len(parts) else ""
                if not val:
                    continue
                prefix.append((rk, val))
                key = tuple(prefix)
                if key not in node_of:
                    node_of[key] = new_node(par, rk, val)
                par = node_of[key]
            n_rows += 1

    with open(os.path.join(out_dir, "nodes.dmp"), "w") as f:
        for tid in sorted(parent):
            f.write(f"{tid}\t|\t{parent[tid]}\t|\t{rank[tid]}\t|\n")
    with open(os.path.join(out_dir, "names.dmp"), "w") as f:
        for tid in sorted(parent):
            f.write(f"{tid}\t|\t{name[tid]}\t|\t\t|\tscientific name\t|\n")
    open(os.path.join(out_dir, "merged.dmp"), "w").close()
    print(f"ictv-format: {n_rows} rows, {len(parent) - 1} taxa -> {out_dir}")
    return out_dir


def make_virus_benchmark_set(assembly_list_path, tax_source, out_dir,
                             rank="genus", exclude_per_rank=1, seed=42):
    """Virus exclusion benchmark: exclude whole genera (default) of
    viruses from the DB, keeping them as novel queries (reference
    makeVirusBenchmarkSet.cpp)."""
    tax = load_db_taxonomy(tax_source)
    rows = load_assembly_list(assembly_list_path)
    rng = random.Random(seed)

    parent_rank = {"species": "genus", "genus": "family", "family": "order"}.get(rank, "family")
    by_parent = defaultdict(set)
    for _, taxid in rows:
        internal = tax.to_internal(taxid)
        if internal == 0:
            continue
        at = int(tax.at_rank_of(internal, rank))
        if at == 0:
            continue
        by_parent[int(tax.at_rank_of(internal, parent_rank))].add(at)

    excluded = set()
    for par, taxa in sorted(by_parent.items()):
        taxa = sorted(taxa)
        if len(taxa) >= 2:
            excluded.update(rng.sample(taxa, min(exclude_per_rank, len(taxa) - 1)))

    os.makedirs(out_dir, exist_ok=True)
    exc_path = os.path.join(out_dir, "virus_queries.tsv")
    db_path = os.path.join(out_dir, "virus_db.tsv")
    with open(exc_path, "w") as fe, open(db_path, "w") as fd:
        for path, taxid in rows:
            internal = tax.to_internal(taxid)
            at = int(tax.at_rank_of(internal, rank)) if internal else 0
            (fe if at in excluded else fd).write(f"{path}\t{taxid}\n")
    print(f"make-virus-benchmark-set: excluded {len(excluded)} {rank} taxa -> {out_dir}")
    return exc_path, db_path
