"""UniRef k-mer database build (`create-uniref-db`).

Reference: UnirefDbCreator + IndexCreator::createLcaKmerIndex
(IndexCreator.cpp:74-149): AA 12-mers from every protein sequence,
labeled with the protein's UniRef100 cluster id; duplicate k-mer values
collapse to the LCA over the 4-level cluster tree (FilterMode::
UNIREF_LCA, IndexCreator.h:541-580).
"""

import json
import os
import time

import numpy as np

from ..io.fasta import read_fasta
from ..ops.encode_aa import extract_protein_kmers
from .tree import UnirefTree


def _entry_cluster_name(header_name: str) -> str:
    """FASTA id -> UniRef100 cluster name (ids are 'UniRef100_...')."""
    return header_name if header_name.startswith("UniRef") else "UniRef100_" + header_name


def build_unique_kmer_db(db_dir, protein_fasta, k: int = 12,
                         syncmer: bool = False, smer_len: int = 5):
    """AA k-mers unique to a single protein (`create-unique-kmer-list`).

    Reference: IndexCreator::createUniqueKmerIndex with FilterMode::
    UNIQ_KMER (IndexCreator.cpp:151-229, IndexCreator.h:566-574): keep a
    k-mer iff every occurrence carries the same sequence id.
    """
    values, ids, names = [], [], []
    for idx, rec in enumerate(read_fasta(protein_fasta)):
        km, _ = extract_protein_kmers(rec.seq, k=k, syncmer=syncmer, smer_len=smer_len)
        if not len(km):
            continue
        values.append(km)
        ids.append(np.full(len(km), idx, dtype=np.int64))
        names.append(rec.name)
    if values:
        v = np.concatenate(values)
        t = np.concatenate(ids)
    else:
        v = np.zeros(0, np.uint64)
        t = np.zeros(0, np.int64)
    order = np.lexsort((t, v))
    v, t = v[order], t[order]
    first = np.ones(len(v), dtype=bool)
    first[1:] = v[1:] != v[:-1]
    gid = np.cumsum(first) - 1
    n_groups = int(gid[-1]) + 1 if len(v) else 0
    mins = np.full(n_groups, np.iinfo(np.int64).max)
    maxs = np.full(n_groups, -1)
    np.minimum.at(mins, gid, t)
    np.maximum.at(maxs, gid, t)
    unique = mins == maxs
    out_v = v[first][unique]
    out_id = t[first][unique]

    os.makedirs(db_dir, exist_ok=True)
    np.save(os.path.join(db_dir, "kmers.npy"), out_v)
    np.save(os.path.join(db_dir, "infos.npy"), out_id.astype(np.int64))
    with open(os.path.join(db_dir, "seq_names.tsv"), "w") as f:
        for i, nm in enumerate(names):
            f.write(f"{i}\t{nm}\n")
    with open(os.path.join(db_dir, "db.meta.json"), "w") as f:
        json.dump({"db_type": "unique_kmer", "kmer_format": 4, "kmer_len": k,
                   "syncmer": syncmer, "smer_len": smer_len,
                   "kmer_count": int(len(out_v)),
                   "creation_date": time.strftime("%Y-%m-%d")}, f, indent=2)
    print(f"create-unique-kmer-list: {len(out_v)} unique k-mers "
          f"from {len(names)} proteins -> {db_dir}")
    return out_v, out_id


def build_uniref_db(db_dir, protein_fasta, tree_path, k: int = 12,
                    syncmer: bool = False, smer_len: int = 5):
    tree = UnirefTree.load(tree_path)
    values, ids = [], []
    n_seq = n_skipped = 0
    for rec in read_fasta(protein_fasta):
        cid = tree.name2id.get(_entry_cluster_name(rec.name)) or tree.name2id.get(rec.name)
        if cid is None:
            n_skipped += 1
            continue
        km, _ = extract_protein_kmers(rec.seq, k=k, syncmer=syncmer, smer_len=smer_len)
        if not len(km):
            continue
        values.append(km)
        ids.append(np.full(len(km), cid, dtype=np.int64))
        n_seq += 1

    if values:
        v = np.concatenate(values)
        t = np.concatenate(ids)
    else:
        v = np.zeros(0, np.uint64)
        t = np.zeros(0, np.int64)

    order = np.lexsort((t, v))
    v, t = v[order], t[order]
    first = np.ones(len(v), dtype=bool)
    first[1:] = v[1:] != v[:-1]
    group = np.cumsum(first) - 1
    out_v = v[first]
    # grouped LCA over the 4-level tree
    out_ids = t[first].copy()
    if len(v):
        dup = ~first
        for i in np.nonzero(dup)[0]:
            g = group[i]
            out_ids[g] = tree.lca_pair(out_ids[g], t[i])

    os.makedirs(db_dir, exist_ok=True)
    np.save(os.path.join(db_dir, "kmers.npy"), out_v)
    np.save(os.path.join(db_dir, "infos.npy"), out_ids.astype(np.int64))
    tree.save(os.path.join(db_dir, "uniref_tree.npz"))
    with open(os.path.join(db_dir, "db.meta.json"), "w") as f:
        json.dump({
            "db_type": "uniref",
            "kmer_format": 4,
            "kmer_len": k,
            "syncmer": syncmer,
            "smer_len": smer_len,
            "kmer_count": int(len(out_v)),
            "sequences": n_seq,
            "creation_date": time.strftime("%Y-%m-%d"),
        }, f, indent=2)
    print(f"create-uniref-db: {len(out_v)} k-mers from {n_seq} proteins "
          f"({n_skipped} without cluster) -> {db_dir}")
    return out_v, out_ids
