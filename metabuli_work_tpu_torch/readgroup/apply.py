"""`apply-group`: propagate group representative labels to members.

Reference: src/read-group/GroupApplier.cpp + workflow/groupApplication.cpp
(defaults weightMode=1, minVoteScr=0.15, scoreCol=5, readIdCol=2,
taxidCol=3): per group, compute the weighted-majority LCA of member
labels (weights: 1 / score / score^2, filtered by min vote score), then
relabel members with the representative and write
`updated_classifications.tsv` with an extra `group` column plus
`groupRep`.

weightedMajorityLCA follows the mmseqs semantics: accumulate each hit's
weight on every node of its root-path; the representative is the deepest
node whose accumulated weight reaches majorityCutoff (0.5) of the total.
"""

import os
from dataclasses import dataclass

from ..index.format import load_db_taxonomy
from ..taxonomy import Taxonomy


@dataclass
class ApplyParams:
    weight_mode: int = 1      # 0 uniform, 1 score, 2 score^2
    min_vote_score: float = 0.15
    score_col: int = 5        # 1-based
    read_id_col: int = 2
    taxid_col: int = 3


def weighted_majority_lca(tax: Taxonomy, taxa, weights, cutoff=0.5):
    """Deepest node whose root-path-accumulated weight >= cutoff * total."""
    if not taxa:
        return 0
    acc = {}
    total = 0.0
    for t, w in zip(taxa, weights):
        total += w
        node = int(t)
        while True:
            acc[node] = acc.get(node, 0.0) + w
            par = int(tax.parent[node])
            if par == node:
                break
            node = par
    best, best_depth = 0, -1
    for node, w in acc.items():
        if w >= cutoff * total:
            d = int(tax.depth[node])
            if d > best_depth or (d == best_depth and acc.get(node, 0) > acc.get(best, 0)):
                best, best_depth = node, d
    return best


def load_org_results(path, params: ApplyParams):
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            taxid = int(cols[params.taxid_col - 1])
            if params.weight_mode == 0 or params.score_col <= 0:
                score = 1.0
            else:
                score = float(cols[params.score_col - 1])
            rows.append((cols[params.read_id_col - 1], taxid, score))
    return rows


def load_groups(groups_path, map_path):
    group_info = {}
    with open(groups_path) as f:
        for line in f:
            parts = [p for p in line.rstrip("\n").split("\t") if p]
            if not parts:
                continue
            gid = int(parts[0])
            group_info[gid] = [int(x) - 1 for x in parts[1:]]  # 0-based
    group_map = []
    with open(map_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                group_map.append(int(parts[1]))
    return group_info, group_map


def apply_groups(groups_path, map_path, tax_source, org_results_path, out_dir,
                 params: ApplyParams = None):
    """tax_source: DB dir containing taxonomy.npz OR a taxdump dir."""
    params = params or ApplyParams()
    tax = load_db_taxonomy(tax_source)

    org = load_org_results(org_results_path, params)
    group_info, group_map = load_groups(groups_path, map_path)

    rep_label = {}
    for gid, members in group_info.items():
        taxa, weights = [], []
        for qi in members:
            if qi >= len(org):
                continue
            _, taxid, score = org[qi]
            internal = tax.to_internal(taxid) if taxid else 0
            if internal == 0:
                continue
            if params.weight_mode == 0:
                taxa.append(internal)
                weights.append(1.0)
            elif score >= params.min_vote_score:
                taxa.append(internal)
                weights.append(score if params.weight_mode == 1 else score * score)
        rep = weighted_majority_lca(tax, taxa, weights, 0.5)
        rep_label[gid] = rep if rep not in (0, tax.root) else 0

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "groupRep"), "w") as f:
        for gid, rep in rep_label.items():
            f.write(f"{gid}\t{tax.orig_of(rep)}\n")

    out_path = os.path.join(out_dir, "updated_classifications.tsv")
    with open(out_path, "w") as f:
        f.write("#is_classified\tname\ttaxID\tquery_length\tscore\trank\tgroup\ttaxID:match_count\n")
        n_updated = 0
        for qi, (name, taxid, score) in enumerate(org):
            gid = group_map[qi] if qi < len(group_map) else 0
            rep = rep_label.get(gid, 0) if gid else 0
            if rep:
                internal = rep
                n_updated += 1
            else:
                internal = tax.to_internal(taxid) if taxid else 0
            gcol = str(gid) if gid else "-"
            # column layout mirrors Reporter::writeReadClassification with
            # a group column (Reporter.cpp:85-140): the rebuilt Query rows
            # carry no length/taxCnt (GroupApplier.cpp:203-215), so
            # classified rows end after the group column and unclassified
            # rows carry the '-' taxCnt placeholder
            if internal:
                f.write(f"1\t{name}\t{tax.orig_of(internal)}\t0\t{score:g}\t{tax.rank_of(internal)}\t{gcol}\t\n")
            else:
                f.write(f"0\t{name}\t0\t0\t{score:g}\t-\t{gcol}\t-\t\n")
    print(f"apply-group: {len(group_info)} groups, results -> {out_path}")
    return out_path
