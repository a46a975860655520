"""`filter` command: contaminant removal.

Reference: QueryFilter (src/commons/QueryFilter.cpp) + workflow/filter.cpp
— classify reads against contaminant database(s) and split the input into
kept (unclassified) and removed (classified) files.
"""

import os

from ..io.fasta import is_fastq, read_seq_file
from .pipeline import Classifier, ClassifyParams


def filter_reads(reads1, db_dirs, out_dir, job_id, params: ClassifyParams,
                 reads2=None, device=None):
    """Classify the reads against each DB of `db_dirs` in turn, on
    `device` (the CUDA card unless "cpu" is asked for), and write the
    reads that no DB classified to <job>_<mate>_kept and the others to
    <job>_<mate>_removed.  Each classifier is dropped before the next DB
    loads, so a list of large DBs needs the device memory of one."""
    classified = set()
    for db in db_dirs:
        clf = Classifier(db, params, device=device)
        results = clf.classify_file(reads1, reads2)
        clf = None
        for i, qr in enumerate(results):
            if qr.result and qr.result.is_classified:
                classified.add(i)

    os.makedirs(out_dir, exist_ok=True)

    def split(path, tag):
        fq = is_fastq(path)
        ext = ".fq" if fq else ".fna"
        kept_p = os.path.join(out_dir, f"{job_id}_{tag}_kept{ext}")
        rm_p = os.path.join(out_dir, f"{job_id}_{tag}_removed{ext}")
        kept = removed = 0
        with open(kept_p, "w") as fk, open(rm_p, "w") as fr:
            for i, rec in enumerate(read_seq_file(path)):
                out = fr if i in classified else fk
                header = rec.name + (" " + rec.comment if rec.comment else "")
                if fq:
                    out.write(f"@{header}\n{rec.seq}\n+\n{rec.qual}\n")
                else:
                    out.write(f">{header}\n{rec.seq}\n")
                if i in classified:
                    removed += 1
                else:
                    kept += 1
        print(f"{tag}: kept {kept}, removed {removed} -> {kept_p}")
        return kept_p, rm_p

    paths = [split(reads1, "1")]
    if reads2:
        paths.append(split(reads2, "2"))
    return paths
