"""`assign_uniref`: exact AA k-mer classification over the UniRef tree.

Reference: UnirefClassifier (src/uniref/UnirefClassifier.cpp): per
protein query, exact-value matches against the UniRef k-mer DB
(matchKmers_AA, KmerMatcher.cpp:686-777); each candidate cluster's vote
is the sum of match counts of its ancestors-or-self; best count wins,
ties merge via tree LCA (UnirefClassifier.cpp:166-196).
"""

import json
import os

import numpy as np

from ..io.fasta import read_fasta
from ..ops.encode_aa import extract_protein_kmers
from .tree import UnirefTree


def assign_uniref(query_fasta, db_dir, out_dir, k: int = None,
                  syncmer: bool = None, smer_len: int = None):
    """Classify every protein of query_fasta over the UniRef DB db_dir;
    writes out_dir/uniref_classifications.tsv and returns its path."""
    with open(os.path.join(db_dir, "db.meta.json")) as f:
        meta = json.load(f)
    k = k or int(meta.get("kmer_len", 12))
    syncmer = bool(meta.get("syncmer", False)) if syncmer is None else syncmer
    smer_len = smer_len or int(meta.get("smer_len", 5))

    values = np.load(os.path.join(db_dir, "kmers.npy"))
    infos = np.load(os.path.join(db_dir, "infos.npy"))
    tree = UnirefTree.load(os.path.join(db_dir, "uniref_tree.npz"))

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "uniref_classifications.tsv")
    n = 0
    with open(out_path, "w") as out:
        out.write("queryId\tqueryName\tunirefId\tunirefName\tlength\tkmerMatchCnt\n")
        for qi, rec in enumerate(read_fasta(query_fasta), start=1):
            km, _ = extract_protein_kmers(rec.seq, k=k, syncmer=syncmer, smer_len=smer_len)
            best, best_cnt = 0, 0
            if len(km):
                lo = np.searchsorted(values, km, side="left")
                hi = np.searchsorted(values, km, side="right")
                hit = hi > lo
                # exact-match model: one DB entry per value (post-LCA dedup)
                cand_ids = infos[lo[hit]]
                if len(cand_ids):
                    uniq, counts = np.unique(cand_ids, return_counts=True)
                    cmap = dict(zip(uniq.tolist(), counts.tolist()))
                    for cid in cmap:
                        total = sum(c2 for u2, c2 in cmap.items()
                                    if tree.is_ancestor(u2, cid))
                        if total > best_cnt:
                            best, best_cnt = cid, total
                        elif total == best_cnt and best:
                            best = tree.lca_pair(best, cid)
            if best:
                out.write(f"{qi}\t{rec.name}\t{best}\t{tree.name_of(best)}\t{len(rec.seq)}\t{best_cnt}\n")
            else:
                out.write(f"{qi}\t{rec.name}\t0\t-\t{len(rec.seq)}\t{best_cnt}\n")
            n += 1
    print(f"assign_uniref: {n} queries -> {out_path}")
    return out_path
