"""`grade` command: per-rank precision/sensitivity/F1 vs an answer sheet.

Reference: src/util/grade.cpp:13-140 — for each read, compare the
classified taxid to the true taxid at each rank: TP if the classified
taxon's ancestor at that rank equals the truth's; FP if classified but
wrong at that rank; FN if unclassified (or classified above the rank).
"""

from ..index.format import load_db_taxonomy

RANKS_DEFAULT = ["species", "genus", "family", "order", "class", "phylum"]


def load_answer_sheet(path):
    """TSV: read_name<TAB>true_taxid (header lines with # ignored)."""
    truth = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                truth[parts[0]] = int(parts[1])
    return truth


def grade(classifications_path, answer_path, db_dir, ranks=None):
    ranks = ranks or RANKS_DEFAULT
    tax = load_db_taxonomy(db_dir)
    truth = load_answer_sheet(answer_path)

    stats = {r: {"tp": 0, "fp": 0, "fn": 0} for r in ranks}
    total = 0
    with open(classifications_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            name = parts[1]
            if name not in truth:
                continue
            total += 1
            try:
                got = int(parts[2])
            except ValueError:
                got = 0
            got_i = tax.to_internal(got) if got else 0
            true_i = tax.to_internal(truth[name])
            for r in ranks:
                true_r = int(tax.at_rank_of(true_i, r)) if true_i else 0
                if true_r == 0:
                    continue  # truth has no taxon at this rank
                got_r = int(tax.at_rank_of(got_i, r)) if got_i else 0
                if got_r == 0:
                    stats[r]["fn"] += 1
                elif got_r == true_r:
                    stats[r]["tp"] += 1
                else:
                    stats[r]["fp"] += 1

    print(f"Graded reads: {total}")
    print("rank\tprecision\tsensitivity\tf1\ttp\tfp\tfn")
    results = {}
    for r in ranks:
        tp, fp, fn = stats[r]["tp"], stats[r]["fp"], stats[r]["fn"]
        prec = tp / (tp + fp) if tp + fp else 0.0
        sens = tp / (tp + fp + fn) if tp + fp + fn else 0.0
        f1 = 2 * prec * sens / (prec + sens) if prec + sens else 0.0
        results[r] = (prec, sens, f1)
        print(f"{r}\t{prec:.4f}\t{sens:.4f}\t{f1:.4f}\t{tp}\t{fp}\t{fn}")
    return results
