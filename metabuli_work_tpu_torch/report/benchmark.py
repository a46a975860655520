"""Benchmark-set machinery + stratified graders.

Reference: src/benchmark/makeBenchmarkSet.cpp (rank-stratified random
*exclusion* sets with a fixed --random-seed), makeInclusionQuerySet.cpp,
src/util/gradeByCoverage.cpp / gradeByCladeSize.cpp / gradeGroup.cpp.

Exclusion set: pick assemblies whose species/genus/family is removed
from the DB build and used as novel queries — measures how well reads
from unseen taxa fall back to the right parent rank.  Inclusion set:
queries sampled from assemblies that stay in the DB.
"""

import os
import random
import tempfile
from collections import defaultdict

from ..index.format import load_db_taxonomy
from .grade import RANKS_DEFAULT, grade, load_answer_sheet


def load_assembly_list(path):
    """TSV: assembly_path<TAB>taxid."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                rows.append((parts[0], int(parts[1])))
    return rows


def make_test_sets(assembly_list_path, tax_source, out_dir, rank="species",
                   exclude_per_rank=1, seed=42):
    """Rank-stratified exclusion sets (reference makeBenchmarkSet.cpp:16-60).

    Groups assemblies by their ancestor at `rank`'s parent level; from
    each group with >= 2 distinct taxa at `rank`, randomly excludes
    `exclude_per_rank` of them.  Writes:
      excluded_assemblies.tsv  (queries — novel at `rank`)
      db_assemblies.tsv        (remaining DB build input)
    """
    tax = load_db_taxonomy(tax_source)
    rows = load_assembly_list(assembly_list_path)
    rng = random.Random(seed)

    parent_rank = {"species": "genus", "genus": "family", "family": "order"}.get(rank, "genus")
    by_parent = defaultdict(set)
    taxon_assemblies = defaultdict(list)
    for path, taxid in rows:
        internal = tax.to_internal(taxid)
        if internal == 0:
            continue
        at = int(tax.at_rank_of(internal, rank))
        if at == 0:
            continue
        par = int(tax.at_rank_of(internal, parent_rank))
        by_parent[par].add(at)
        taxon_assemblies[at].append((path, taxid))

    excluded_taxa = set()
    for par, taxa in sorted(by_parent.items()):
        taxa = sorted(taxa)
        if len(taxa) >= 2:
            excluded_taxa.update(rng.sample(taxa, min(exclude_per_rank, len(taxa) - 1)))

    os.makedirs(out_dir, exist_ok=True)
    exc_path = os.path.join(out_dir, "excluded_assemblies.tsv")
    db_path = os.path.join(out_dir, "db_assemblies.tsv")
    n_exc = n_db = 0
    with open(exc_path, "w") as fe, open(db_path, "w") as fd:
        for path, taxid in rows:
            internal = tax.to_internal(taxid)
            at = int(tax.at_rank_of(internal, rank)) if internal else 0
            if at in excluded_taxa:
                fe.write(f"{path}\t{taxid}\n")
                n_exc += 1
            else:
                fd.write(f"{path}\t{taxid}\n")
                n_db += 1
    print(f"maketestsets: excluded {len(excluded_taxa)} {rank} taxa "
          f"({n_exc} assemblies) of {len(taxon_assemblies)}; DB keeps {n_db}")
    return exc_path, db_path


def make_inclusion_queries(assembly_list_path, out_dir, fraction=0.3, seed=42):
    """Sample assemblies that remain in the DB as inclusion queries."""
    rows = load_assembly_list(assembly_list_path)
    rng = random.Random(seed)
    sel = rng.sample(range(len(rows)), max(1, int(len(rows) * fraction)))
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "inclusion_queries.tsv")
    with open(out, "w") as f:
        for i in sorted(sel):
            f.write(f"{rows[i][0]}\t{rows[i][1]}\n")
    print(f"makeInclusionTestQueries: {len(sel)} assemblies -> {out}")
    return out


def grade_by_strata(classifications_path, answer_path, db_dir, strata_path,
                    ranks=None, label="stratum"):
    """Grade per stratum (coverage bucket, clade size, ...).

    strata_path: TSV read_name<TAB>stratum.  Underlies gradeByCoverage /
    gradeByCladeSize (reference stratifies internally; here the stratum
    assignment is an explicit input).
    """
    strata = {}
    with open(strata_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and not line.startswith("#"):
                strata[parts[0]] = parts[1]

    by_stratum = defaultdict(list)
    header = None
    with open(classifications_path) as f:
        for line in f:
            if line.startswith("#"):
                header = line
                continue
            name = line.split("\t")[1] if line.count("\t") else None
            if name in strata:
                by_stratum[strata[name]].append(line)

    results = {}
    for stratum, lines in sorted(by_stratum.items()):
        with tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False) as tf:
            if header:
                tf.write(header)
            tf.writelines(lines)
            tmp = tf.name
        print(f"--- {label}: {stratum} ({len(lines)} reads) ---")
        results[stratum] = grade(tmp, answer_path, db_dir, ranks=ranks)
        os.unlink(tmp)
    return results


def grade_group(groups_path, answer_path, db_dir, ranks=None):
    """Group-quality grading (reference gradeGroup.cpp): per group,
    measure label purity of the true taxa of its members at each rank."""
    ranks = ranks or RANKS_DEFAULT
    tax = load_db_taxonomy(db_dir)
    truth = load_answer_sheet(answer_path)
    # answers keyed by read index (read names "..." -> index via sorted order
    # is unsafe); accept both name->taxid and index->taxid sheets
    idx_truth = {}
    for k, v in truth.items():
        try:
            idx_truth[int(k)] = v
        except ValueError:
            pass

    groups = {}
    with open(groups_path) as f:
        for line in f:
            parts = [p for p in line.rstrip("\n").split("\t") if p]
            if len(parts) >= 2:
                groups[int(parts[0])] = [int(x) for x in parts[1:]]

    print("rank\tgroups\tweighted_purity\tmax_group_size")
    results = {}
    for rank in ranks:
        total_members = 0
        weighted_purity = 0.0
        max_size = 0
        for gid, members in groups.items():
            taxa = []
            for rid in members:
                t = idx_truth.get(rid) or truth.get(str(rid))
                if t is None:
                    continue
                internal = tax.to_internal(t)
                at = int(tax.at_rank_of(internal, rank)) if internal else 0
                if at:
                    taxa.append(at)
            if not taxa:
                continue
            counts = defaultdict(int)
            for t in taxa:
                counts[t] += 1
            purity = max(counts.values()) / len(taxa)
            weighted_purity += purity * len(taxa)
            total_members += len(taxa)
            max_size = max(max_size, len(members))
        wp = weighted_purity / total_members if total_members else 0.0
        results[rank] = wp
        print(f"{rank}\t{len(groups)}\t{wp:.4f}\t{max_size}")
    return results


def grade_group_by_strata(groups_path, answer_path, db_dir, strata_path,
                          ranks=None, label="coverage"):
    """Group purity per stratum (reference gradeGroupByCoverage.cpp):
    split each group's members by their stratum (e.g. read coverage
    bucket) and grade purity within each stratum separately."""
    strata = {}
    with open(strata_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and not line.startswith("#"):
                strata[parts[0]] = parts[1]

    groups = {}
    with open(groups_path) as f:
        for line in f:
            parts = [p for p in line.rstrip("\n").split("\t") if p]
            if len(parts) >= 2:
                groups[int(parts[0])] = parts[1:]

    by_stratum = defaultdict(dict)
    for gid, members in groups.items():
        for rid in members:
            s = strata.get(str(rid)) or strata.get(rid)
            if s is None:
                continue
            by_stratum[s].setdefault(gid, []).append(rid)

    results = {}
    for stratum, sub_groups in sorted(by_stratum.items()):
        with tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False) as tf:
            for gid, members in sorted(sub_groups.items()):
                tf.write("\t".join([str(gid)] + [str(m) for m in members]) + "\n")
            tmp = tf.name
        n = sum(len(m) for m in sub_groups.values())
        print(f"--- {label}: {stratum} ({len(sub_groups)} groups, {n} members) ---")
        results[stratum] = grade_group(tmp, answer_path, db_dir, ranks=ranks)
        os.unlink(tmp)
    return results


def mapping2taxon(mapping_path, db_dir, out_path, rank="species"):
    """Convert a read->taxid mapping to read->taxon-at-rank (reference
    src/util/mapping2taxon.cpp)."""
    tax = load_db_taxonomy(db_dir)
    n = 0
    with open(mapping_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            internal = tax.to_internal(int(parts[1]))
            at = int(tax.at_rank_of(internal, rank)) if internal else 0
            fout.write(f"{parts[0]}\t{tax.orig_of(at)}\t{tax.name_of(at) if at else '-'}\n")
            n += 1
    print(f"mapping2taxon: {n} rows -> {out_path}")
    return out_path
