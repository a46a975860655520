"""`updateDB`: incremental index update.

Reference: workflow/updateDB.cpp:36-158 — extract k-mers from the new
sequences, then merge with the existing DB's entries, re-applying the
per-(value, species) LCA dedup across old + new.  New taxa can be
grafted onto the taxonomy before the merge (addNewTaxa; here: new nodes
appended from a TSV of (taxid, parent, rank, name)).

The new sequences are extracted with the old DB's parameters as
load_index gives them: its db.meta.json, or, for a DB of the reference
binary, its db.parameters (whose orf_prediction is 1 with the
'prodigal' predictor, the reference's own extraction).
"""

import os

import numpy as np

from ..taxonomy import Taxonomy
from .builder import (IndexBuilder, _dedup_lca, extract_records,
                      load_acc2taxid)
from .format import KmerIndex, load_index, save_index


def graft_new_taxa(tax: Taxonomy, new_taxa_path) -> Taxonomy:
    """Append new taxonomy nodes (TSV: taxid, parentTaxid, rank, name)."""
    parent = list(tax.parent)
    rank_idx = list(tax.rank_idx)
    name_idx = list(tax.name_idx)
    rank_pool = list(tax.rank_pool)
    name_pool = list(tax.name_pool)
    int2orig = list(tax.int2orig)
    orig2int = dict(tax.orig2int)

    def pool(p, s):
        if s in p:
            return p.index(s)
        p.append(s)
        return len(p) - 1

    with open(new_taxa_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            tid_s, par_s, rank, name = line.rstrip("\n").split("\t")[:4]
            tid, par = int(tid_s), int(par_s)
            if tid in orig2int:
                continue
            pi = orig2int.get(par)
            if pi is None:
                raise SystemExit(f"new taxon {tid}: parent {par} not in taxonomy")
            i = len(parent)
            parent.append(pi)
            rank_idx.append(pool(rank_pool, rank))
            name_idx.append(pool(name_pool, name))
            int2orig.append(tid)
            orig2int[tid] = i

    out = Taxonomy(np.array(parent), np.array(rank_idx), np.array(name_idx),
                   rank_pool, name_pool, np.array(int2orig))
    out.merged = getattr(tax, "merged", {})
    return out


def update_database(
    old_db_dir,
    new_db_dir,
    fasta_list_path,
    acc2taxid_path,
    new_taxa_path=None,
    max_ram_gb: float = 32.0,
):
    old = load_index(old_db_dir)
    tax = old.taxonomy
    if new_taxa_path:
        tax = graft_new_taxa(tax, new_taxa_path)

    acc2taxid = load_acc2taxid(acc2taxid_path)
    meta = old.meta
    builder = IndexBuilder(
        tax,
        syncmer=bool(meta.get("syncmer", False)),
        smer_len=int(meta.get("smer_len", 5)),
        mask_mode=int(meta.get("mask_mode", 0)),
        mask_prob=float(meta.get("mask_prob", 0.9)),
        max_ram_gb=max_ram_gb,
    )
    with open(fasta_list_path) as f:
        fasta_files = [ln.strip() for ln in f if ln.strip()]
    # extract the new sequences exactly the way the old DB was built
    # (Prodigal extended-ORF blocks, heuristic ORFs, or plain 6-frame) —
    # the reference funnels updateDB through the same IndexCreator
    # (workflow/updateDB.cpp:103-105)
    acc_rows: list = []
    extract_records(
        builder, tax, fasta_files, acc2taxid,
        orf_prediction=bool(meta.get("orf_prediction", 0)),
        gene_predictor=str(meta.get("gene_predictor", "auto")),
        acc_map_out=acc_rows)
    new = builder.finalize()

    # merge old + new with cross-set dedup (old taxids stay authoritative
    # for shared k-mers via LCA)
    values = np.concatenate([old.values, new.values])
    taxids = np.concatenate([old.taxids, new.taxids]).astype(np.int32)
    species = np.concatenate([old.species, new.species]).astype(np.int32)
    values, taxids, species = _dedup_lca(values, taxids, species, tax)

    merged = KmerIndex(values, taxids, species, tax, dict(meta))
    merged.meta["db_name"] = os.path.basename(str(new_db_dir))
    save_index(new_db_dir, merged)
    # carry forward + extend accession map
    old_map = os.path.join(old_db_dir, "acc2taxid.map")
    with open(os.path.join(new_db_dir, "acc2taxid.map"), "w") as f:
        if os.path.exists(old_map):
            f.write(open(old_map).read())
        for acc, tid in acc_rows:
            f.write(f"{acc}\t{tid}\n")
    return merged
