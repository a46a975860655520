"""Input validation (--validate-input).

Reference: vendored lib/fasta_validator + lib/fastq_utils invoked from
workflow/classify.cpp:67-94.  Checks structural well-formedness and
returns (ok, message).
"""

from .fasta import _open, is_fastq

_VALID_SEQ = set("ACGTUNRYSWKMBDHVacgtunryswkmbdhv.-")


def validate_fasta(path, check_chars=True):
    n = 0
    seen = set()
    with _open(path) as f:
        expecting_header = True
        has_seq = False
        name = None
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None and not has_seq:
                    return False, f"line {lineno}: record '{name}' has no sequence"
                name = line[1:].split()[0] if len(line) > 1 else ""
                if not name:
                    return False, f"line {lineno}: empty sequence name"
                if name in seen:
                    return False, f"line {lineno}: duplicate sequence name '{name}'"
                seen.add(name)
                has_seq = False
                n += 1
            else:
                if name is None:
                    return False, f"line {lineno}: sequence data before first header"
                if check_chars and not set(line) <= _VALID_SEQ:
                    bad = sorted(set(line) - _VALID_SEQ)[:5]
                    return False, f"line {lineno}: invalid characters {bad}"
                has_seq = True
        if name is not None and not has_seq:
            return False, f"record '{name}' has no sequence"
    if n == 0:
        return False, "no FASTA records found"
    return True, f"{n} records"


def validate_fastq(path):
    n = 0
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            h = h.rstrip("\n")
            if not h:
                continue
            if not h.startswith("@"):
                return False, f"record {n + 1}: header does not start with '@'"
            seq = f.readline().rstrip("\n")
            plus = f.readline().rstrip("\n")
            qual = f.readline().rstrip("\n")
            if not plus.startswith("+"):
                return False, f"record {n + 1}: separator line is not '+'"
            if len(seq) != len(qual):
                return False, (f"record {n + 1}: sequence length {len(seq)} != "
                               f"quality length {len(qual)}")
            if not seq:
                return False, f"record {n + 1}: empty sequence"
            n += 1
    if n == 0:
        return False, "no FASTQ records found"
    return True, f"{n} records"


def validate_input(path):
    return validate_fastq(path) if is_fastq(path) else validate_fasta(path)
