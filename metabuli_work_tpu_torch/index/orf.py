"""Host-side prokaryotic ORF prediction for DB builds.

Plays the role Prodigal plays in the reference build pipeline
(reference src/commons/ProdigalWrapper.{h,cpp}; invoked from
IndexCreator::fillTargetKmerBuffer, src/commons/IndexCreator.cpp:
1124-1212): restrict target k-mer extraction to (extended) coding
blocks in a consistent frame instead of all six frames, which shrinks
the index and removes off-frame noise k-mers.

This is deliberately NOT a Prodigal port: Prodigal's trained dynamic
programming (GC-frame bias, RBS motifs, start-codon scoring) is a
build-time quality refinement, while the contract with the rest of the
pipeline is only the final block list per sequence (reference
SequenceBlock{start,end,strand}).  Here genes are approximated by
maximal open reading frames:

* scan all 6 frames for stop codons (TAA/TAG/TGA);
* within each stop-to-stop segment take the region from the first
  start codon (ATG/GTG/TTG) to the stop, keeping it when it is at
  least ``min_gene`` nt; ALL such maximal ORFs are kept (no
  overlap resolution) — for an index a superset of the true genes
  only costs a few redundant k-mers, whereas a dropped gene loses
  sensitivity;
* each kept gene is extended ``extend`` nt into its flanking
  intergenic regions, frame-aligned, the analogue of the reference's
  extended-ORF mechanism (ProdigalWrapper::getExtendedORFs,
  src/commons/ProdigalWrapper.cpp:344-561) which indexes each
  intergenic stretch once in a consistent frame.

Coordinates in the returned blocks are 0-based inclusive (start, end,
strand) on the FORWARD sequence, matching IndexBuilder.add_sequence's
``cds_blocks`` contract.
"""

import numpy as np

from ..ops.genetic_code import seq_to_codes

_STOPS = {"TAA", "TAG", "TGA"}
_STARTS = {"ATG", "GTG", "TTG"}


def _codon_strings(codes: np.ndarray, offset: int):
    """3-bit codes -> per-codon classification arrays for one frame."""
    n = (len(codes) - offset) // 3
    if n <= 0:
        return np.zeros(0, bool), np.zeros(0, bool)
    c = codes[offset : offset + 3 * n].reshape(n, 3).astype(np.int32)
    # 3-bit codes: A=0.. per genetic_code.NUC_CODE; build codon ordinal
    key = (c[:, 0] << 6) | (c[:, 1] << 3) | c[:, 2]
    stop_keys, start_keys = _KEY_SETS
    return np.isin(key, stop_keys), np.isin(key, start_keys)


def _build_key_sets():
    from ..ops.genetic_code import NUC_CODE

    def key_of(codon):
        a, b, c = (NUC_CODE[ord(x)] for x in codon)
        return (int(a) << 6) | (int(b) << 3) | int(c)

    stops = np.array(sorted(key_of(c) for c in _STOPS), dtype=np.int32)
    starts = np.array(sorted(key_of(c) for c in _STARTS), dtype=np.int32)
    return stops, starts


_KEY_SETS = _build_key_sets()


def _frame_orfs(is_stop, is_start, offset, n_codons, min_codons):
    """ORF (start_codon_idx, end_codon_idx incl. stop) pairs for one frame."""
    orfs = []
    stop_idx = np.nonzero(is_stop)[0]
    seg_begin = 0
    for s in list(stop_idx) + [n_codons]:
        if s > seg_begin:
            starts = np.nonzero(is_start[seg_begin:s])[0]
            if len(starts):
                first = seg_begin + int(starts[0])
                # include the stop codon when present (s < n_codons)
                end = s if s < n_codons else n_codons - 1
                if end - first + 1 >= min_codons:
                    orfs.append((first, end))
        seg_begin = s + 1
    return orfs


def predict_orfs(seq: str, min_gene: int = 90, extend: int = 22):
    """Approximate gene calls -> extended blocks [(start, end, strand)].

    min_gene: minimum gene length in nt (Prodigal default region is
    90 nt); extend: nt of flanking intergenic sequence folded into each
    block, frame-aligned (reference extends 22 nt, ProdigalWrapper.cpp).
    """
    from ..ops.genetic_code import COMP_CODE

    codes = seq_to_codes(seq)
    L = len(codes)
    rc = COMP_CODE[codes[::-1]]
    min_codons = max(2, min_gene // 3)

    calls = []  # (length, start, end, strand) in forward coords; length
    # kept for interface stability (callers may sort by it)
    for strand, base in ((1, codes), (-1, rc)):
        for offset in range(3):
            n = (L - offset) // 3
            if n <= 0:
                continue
            is_stop, is_start = _codon_strings(base, offset)
            for c0, c1 in _frame_orfs(is_stop, is_start, offset, n, min_codons):
                b = offset + 3 * c0
                e = offset + 3 * c1 + 2
                if strand < 0:  # map reverse-strand coords to forward
                    b, e = L - 1 - e, L - 1 - b
                calls.append((e - b + 1, b, e, strand))

    # extend into flanks, frame-aligned (multiples of 3 so the block
    # keeps the gene's reading frame)
    blocks = []
    for _, b, e, strand in calls:
        b2 = max(0, b - (extend // 3) * 3)
        e2 = min(L - 1, e + (extend // 3) * 3)
        blocks.append((b2, e2, strand))
    blocks.sort()
    return blocks
