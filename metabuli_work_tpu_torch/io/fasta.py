"""FASTA/FASTQ readers (plain or gzip) — host input path.

Replaces the reference's kseq-based KSeqWrapper (mmseqs submodule,
used via src/commons/KmerExtractor.cpp) with a small streaming parser.
Throughput matters less than the device pipeline; parsing is line-based
and batched by the caller.
"""

import gzip
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class SeqRecord:
    name: str          # id up to first whitespace
    comment: str       # remainder of the header ('' if none)
    seq: str
    qual: Optional[str] = None


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _split_header(line: str):
    h = line[1:].rstrip("\n")
    for i, ch in enumerate(h):
        if ch in " \t":
            return h[:i], h[i + 1:]
    return h, ""


def read_fasta(path) -> Iterator[SeqRecord]:
    name, comment, chunks = None, "", []
    with _open(path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    yield SeqRecord(name, comment, "".join(chunks))
                name, comment = _split_header(line)
                chunks = []
            else:
                chunks.append(line.strip())
        if name is not None:
            yield SeqRecord(name, comment, "".join(chunks))


def read_fastq(path) -> Iterator[SeqRecord]:
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            if not h.strip():
                continue
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            name, comment = _split_header(h)
            yield SeqRecord(name, comment, seq, qual)


def is_fasta(path) -> bool:
    p = str(path)
    for ext in (".fna", ".fasta", ".fa"):
        if p.endswith(ext) or p.endswith(ext + ".gz"):
            return True
    return False


def is_fastq(path) -> bool:
    p = str(path)
    for ext in (".fq", ".fastq"):
        if p.endswith(ext) or p.endswith(ext + ".gz"):
            return True
    return False


def read_seq_file(path) -> Iterator[SeqRecord]:
    """Dispatch on extension; unknown extensions are sniffed."""
    if is_fastq(path):
        return read_fastq(path)
    if is_fasta(path):
        return read_fasta(path)
    with _open(path) as f:
        first = f.read(1)
    return read_fastq(path) if first == "@" else read_fasta(path)
