"""`classifiedRefiner`: filter/reshape a classification TSV.

Reference: src/util/classifiedRefiner.cpp (README.md:252-276): apply a
minimum score, include/exclude taxid subtrees, collapse assignments to a
higher rank, and re-emit the TSV (plus an updated report).
"""

from ..index.format import load_db_taxonomy


def refine(
    classifications_path,
    db_dir,
    out_path=None,
    min_score: float = 0.0,
    include_taxids=None,
    exclude_taxids=None,
    rank: str = "",
):
    tax = load_db_taxonomy(db_dir)
    inc = [tax.to_internal(t) for t in (include_taxids or [])]
    exc = [tax.to_internal(t) for t in (exclude_taxids or [])]
    out_path = out_path or classifications_path + ".refined"

    kept = dropped = 0
    with open(classifications_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                fout.write(line)
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6:
                continue
            try:
                taxid = int(parts[2])
                score = float(parts[4])
            except ValueError:
                continue
            internal = tax.to_internal(taxid) if taxid else 0

            ok = parts[0] == "1" and internal != 0 and score >= min_score
            if ok and inc:
                ok = any(bool(tax.is_ancestor(t, internal)) for t in inc)
            if ok and exc:
                ok = not any(bool(tax.is_ancestor(t, internal)) for t in exc)
            if not ok:
                dropped += 1
                continue
            if rank:
                at = int(tax.at_rank_of(internal, rank))
                if at:
                    parts[2] = str(tax.orig_of(at))
                    parts[5] = rank
            kept += 1
            fout.write("\t".join(parts) + "\n")
    print(f"Refined: kept {kept}, dropped {dropped} -> {out_path}")
    return out_path
