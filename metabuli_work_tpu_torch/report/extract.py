"""`extract` command: pull reads classified under a clade.

Reference: workflow/extract.cpp + Reporter::getReadsClassifiedToClade /
printSpecifiedReads (src/commons/Reporter.cpp:296-415): scan the
classification TSV, select rows whose taxid lies under the clade, then
stream the read file emitting selected records.
"""

from ..index.format import load_db_taxonomy
from ..io.fasta import is_fastq, read_seq_file


def extract_reads(classifications_path, reads_path, tax_id, db_dir, extract_mode=0):
    tax = load_db_taxonomy(db_dir)
    clade = tax.to_internal(tax_id)
    if clade == 0:
        raise SystemExit(f"taxID {tax_id} not found in DB taxonomy")

    selected = set()
    idx = 0
    with open(classifications_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                try:
                    t = int(parts[2])
                except ValueError:
                    t = 0
                internal = tax.to_internal(t) if t else 0
                if internal and bool(tax.is_ancestor(clade, internal)):
                    selected.add(idx)
            idx += 1

    src_fastq = is_fastq(reads_path)
    if extract_mode == 2 and not src_fastq:
        raise SystemExit("Cannot convert FASTA to FASTQ")
    emit_fasta = (extract_mode == 1) or not src_fastq
    base = str(reads_path)
    for ext in (".gz", ".fna", ".fasta", ".fa", ".fq", ".fastq"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    out_path = base + "_" + str(tax_id) + (".fna" if emit_fasta else ".fq")

    n = 0
    with open(out_path, "w") as out:
        for i, rec in enumerate(read_seq_file(reads_path)):
            if i not in selected:
                continue
            header = rec.name + (" " + rec.comment if rec.comment else "")
            if emit_fasta:
                out.write(f">{header}\n{rec.seq}\n")
            else:
                out.write(f"@{header}\n{rec.seq}\n+{header}\n{rec.qual}\n")
            n += 1
    print(f"Extracted {n} reads under taxID {tax_id} -> {out_path}")
    return out_path
