"""Prodigal gene prediction for DB builds (ctypes over libprodigal.so).

The reference restricts target k-mer extraction to Prodigal-predicted
*extended ORFs* (reference src/commons/ProdigalWrapper.{h,cpp}, driven
from IndexCreator::fillTargetKmerBuffer, IndexCreator.cpp:1124-1212):

* per species, train Prodigal on the species' longest sequence
  (single-genome mode when >= 100 kb and not eukaryotic, else the
  metagenome bin sweep, IndexCreator.cpp:1134-1145);
* build the species' intergenic 23-mer XXH64 list from the training
  sequence's gene calls (SeqIterator::generateIntergenicKmerList,
  SeqIterator.cpp:114-152);
* per sequence, check strand orientation vs the training sequence by
  min-hash (reverse-complementing on mismatch, IndexCreator.cpp:
  1158-1212), predict genes, drop completely-overlapped genes, and
  stitch genes + flanking intergenic stretches into frame-aligned
  SequenceBlocks (ProdigalWrapper::getExtendedORFs, ProdigalWrapper.cpp:
  344-562) — each intergenic stretch is indexed exactly once, in a
  consistent frame, the 23-mer hash list deciding the direction every
  extension goes.

The native library is compiled at first use from native/prodigal_api.cpp
and the vendored third-party Prodigal 2.6.3 sources that native/Makefile
names (its PRODIGAL_REF directory, minus training.cpp, plus the shim's
prodigal_training.cpp), into build/torch_kernels/libprodigal.so; nothing
is written into native/.  When those sources are absent the build fails,
available() is False and an ORF build under gene_predictor='auto' runs
the heuristic scan of index/orf.py.  This module adds the
block-stitching logic, which follows the reference bit for bit.

The reference snapshot lacks Prodigal's metagenome training models
(empty training.cpp), so meta-mode predictions — short (<100 kb) or
eukaryotic training sequences — run with zeroed models; single-genome
training is complete and is what every >= 100 kb prokaryotic species
uses.
"""

import ctypes
import glob
import os

import numpy as np

from ..utils.build import NATIVE_DIR, REPO_ROOT, build_library

_LIB = None
_ERROR = None

# Prodigal caps input sequences at 32 Mbp (lib/prodigal
# prodigalsequence.h MAX_SEQ); longer contigs are truncated exactly as
# the reference's getNextSeq does (ProdigalWrapper.cpp:296-300).
MAX_SEQ = 32_000_000
_MAX_GENES = 30_000

_K = 23  # intergenic k-mer length (ProdigalWrapper.cpp:380)

# IUPAC reverse-complement table, reference common.cpp iRCT
_IRCT = {}
for _a, _b in zip("ABCDGHKMNRSTUVWY", "TVGHCDMKNYSAABWR"):
    _IRCT[_a] = _b
    _IRCT[_a.lower()] = _b.lower()


def _makefile_sources():
    """(sources, include dirs) of native/Makefile's libprodigal.so rule:
    prodigal_api.cpp, every .cpp of the PRODIGAL_REF directory but
    training.cpp, and the shim's prodigal_training.cpp."""
    ref = None
    with open(os.path.join(NATIVE_DIR, "Makefile")) as f:
        for line in f:
            if line.startswith("PRODIGAL_REF"):
                ref = line.split("=", 1)[1].strip()
    if ref is None:
        raise RuntimeError("native/Makefile names no PRODIGAL_REF")
    ref = os.path.join(NATIVE_DIR, ref)
    shim = os.path.join(REPO_ROOT, "reference_build", "shim")
    vendored = sorted(glob.glob(os.path.join(ref, "*.cpp")))
    srcs = [os.path.join(NATIVE_DIR, "prodigal_api.cpp"),
            *(p for p in vendored if os.path.basename(p) != "training.cpp"),
            os.path.join(shim, "prodigal_training.cpp")]
    return srcs, [ref, shim]


def _load():
    """The library, built on first use; raises RuntimeError (the build's
    reason) when it cannot be built or loaded."""
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            srcs, incs = _makefile_sources()
            lib = ctypes.CDLL(build_library(
                srcs, "libprodigal.so",
                ["g++", "-O2", "-Wall", "-shared", "-fPIC", "-O3",
                 *(f"-I{d}" for d in incs)]))
        except (RuntimeError, OSError) as e:
            _ERROR = str(e)
        else:
            lib.mwp_new.restype = ctypes.c_void_p
            lib.mwp_free.argtypes = [ctypes.c_void_p]
            lib.mwp_train.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_long, ctypes.c_int]
            lib.mwp_train.restype = ctypes.c_int
            lib.mwp_predict.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.mwp_predict.restype = ctypes.c_int
            lib.mwp_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_long]
            lib.mwp_xxh64.restype = ctypes.c_uint64
            _LIB = lib
    if _LIB is None:
        raise RuntimeError(_ERROR)
    return _LIB


def available() -> bool:
    """True when the vendored Prodigal library can be built/loaded."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def unavailable_reason():
    """Why the library cannot be built (None when it can)."""
    return None if available() else _ERROR


def xxh64(data: bytes) -> int:
    return int(_load().mwp_xxh64(data, len(data)))


class ProdigalRunner:
    """One trained predictor (the reference holds one per species batch)."""

    def __init__(self):
        lib = _load()
        self._lib = lib
        self._h = lib.mwp_new()
        self.is_meta = False

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mwp_free(self._h)
            self._h = None

    def train(self, seq: str, meta: bool = False):
        """Train on a species' longest sequence.  meta=True mirrors the
        reference's choice for <100 kb or eukaryotic training sequences
        (IndexCreator.cpp:1134-1145)."""
        r = self._lib.mwp_train(self._h, seq.encode(), len(seq), int(meta))
        if r != 0:
            raise ValueError("prodigal training failed (empty sequence?)")
        self.is_meta = meta

    def predict(self, seq: str):
        """Gene calls after dropping completely-overlapped genes
        (ProdigalWrapper::removeCompletelyOverlappingGenes).

        Returns (begins, ends, strands): 1-based inclusive coordinates,
        strand +-1, sorted by begin."""
        b = (ctypes.c_int * _MAX_GENES)()
        e = (ctypes.c_int * _MAX_GENES)()
        s = (ctypes.c_int * _MAX_GENES)()
        n = self._lib.mwp_predict(self._h, seq.encode(), len(seq),
                                  b, e, s, _MAX_GENES)
        if n < 0:
            raise ValueError("prodigal prediction failed")
        return (np.frombuffer(b, np.int32, n).copy(),
                np.frombuffer(e, np.int32, n).copy(),
                np.frombuffer(s, np.int32, n).copy())


def _rc_kmer(kmer: str) -> bytes:
    return "".join(_IRCT.get(c, ".") for c in reversed(kmer)).encode()


def _hash_kmer(seq: str, pos: int, reverse: bool) -> int:
    """XXH64 of seq[pos:pos+23], reverse-complemented for reverse genes.

    The reference strncpy's from seq+pos into a 23-byte buffer
    (SeqIterator.cpp:139, ProdigalWrapper.cpp:410-412): copying stops
    at the NUL terminator and the remainder is zero-padded — a
    well-defined behavior for windows running past the sequence end
    (Prodigal routinely calls run-off genes with end == len(seq)), so
    the hash is of seq[pos:] + b"\\0"*pad.  For the reverse case each
    padding byte maps through iRCT[0] == '.' (GeneticCode.h:14).
    Windows that would START before the sequence are a true OOB read
    in the reference; those are clamped to 0 — the only behavior that
    cannot be reproduced."""
    pos = max(0, pos)
    kmer = seq[pos:pos + _K].ljust(_K, "\0")
    return xxh64(_rc_kmer(kmer) if reverse else kmer.encode())


def generate_intergenic_kmer_list(begins, ends, strands, seq: str):
    """Intergenic 23-mer hash list from the training sequence's genes
    (reference SeqIterator::generateIntergenicKmerList,
    SeqIterator.cpp:114-152)."""
    out = []
    n = len(begins)
    if n == 0:
        return out
    first_left = int(begins[0]) - 1
    if first_left > _K - 1:
        out.append(_hash_kmer(seq, first_left - _K, strands[0] != 1))
    for i in range(n):
        out.append(_hash_kmer(seq, int(ends[i]), strands[i] != 1))
    return out


def get_extended_orfs(begins, ends, strands, length: int,
                      intergenic: list, seq: str):
    """Stitch gene calls + intergenic flanks into frame-aligned blocks
    (reference ProdigalWrapper::getExtendedORFs, ProdigalWrapper.cpp:
    344-562).  Coordinates in: 1-based inclusive gene calls; out:
    0-based inclusive (start, end, strand) blocks on the given strand's
    sequence.  `intergenic` is the species' running 23-mer hash list —
    MUTATED here exactly like the reference mutates it across the
    sequences of a species batch."""
    n = len(begins)
    blocks = []
    if n == 0:
        blocks.append((0, length - 1, 1))
        return blocks
    if n == 1:
        if strands[0] == 1:
            frame = (int(begins[0]) - 1) % 3
            left = 0
            while left % 3 != frame:
                left += 1
            blocks.append((left, length - 1, 1))
        else:
            frame = (int(ends[0]) - 1) % 3
            right = length - 1
            while right % 3 != frame:
                right -= 1
            blocks.append((0, right, -1))
        return blocks

    extended_left = False
    is_reverse = False
    left_hash = 0
    right_hash = 0

    # First gene: cover the leading region through the next gene's flank
    if strands[0] == 1:
        frame = (int(begins[0]) - 1) % 3
        left = 0
        while left % 3 != frame:
            left += 1
        blocks.append((left, int(begins[1]) - 1 + 22, 1))
    else:
        frame = (int(ends[0]) - 1) % 3
        right = int(begins[1]) - 1 + 22
        while right % 3 != frame:
            right -= 1
        blocks.append((0, right, -1))

    # Middle genes: the intergenic-hash list decides whether each gene
    # extends left (its left flank was already indexed) or right
    for g in range(1, n - 1):
        is_reverse = strands[g] != 1
        left_hash = _hash_kmer(seq, int(begins[g]) - 1 - _K, is_reverse)
        right_hash = _hash_kmer(seq, int(ends[g]), is_reverse)

        if left_hash in intergenic:     # extension to left
            if not extended_left:
                blocks.append((int(begins[g]) - 1, int(ends[g]) - 1,
                               -1 if is_reverse else 1))
            else:
                if not is_reverse:
                    frame = (int(begins[g]) - 1) % 3
                    left = int(ends[g - 1]) - 1 - 22
                    while left % 3 != frame:
                        left += 1
                    blocks.append((left, int(ends[g]) - 1, 1))
                else:
                    blocks.append((int(ends[g - 1]) - 22 - 1,
                                   int(ends[g]) - 1, -1))
            extended_left = True
        else:                           # extension to right
            if extended_left:
                if not is_reverse:
                    frame = (int(begins[g]) - 1) % 3
                    left = int(ends[g - 1]) - 1 - 22
                    while left % 3 != frame:
                        left += 1
                    blocks.append((left, int(begins[g + 1]) - 1 + 22, 1))
                else:
                    frame = (int(ends[g]) - 1) % 3
                    right = int(begins[g + 1]) - 1 + 22
                    while right % 3 != frame:
                        right -= 1
                    blocks.append((int(ends[g - 1]) - 1 - 22, right, -1))
            else:
                if not is_reverse:
                    blocks.append((int(begins[g]) - 1,
                                   int(begins[g + 1]) - 1 + 22, 1))
                else:
                    frame = (int(ends[g]) - 1) % 3
                    right = int(begins[g + 1]) - 1 + 22
                    while right % 3 != frame:
                        right -= 1
                    blocks.append((int(begins[g]) - 1, right, -1))
            extended_left = False
            if right_hash not in intergenic:
                intergenic.append(right_hash)

    # Last gene: note left_hash/right_hash/is_reverse deliberately carry
    # over from the last middle iteration (zeros when n == 2), exactly
    # like the reference (ProdigalWrapper.cpp:506-554)
    if left_hash in intergenic:         # extension to left
        if not is_reverse:
            frame = (int(begins[n - 1]) - 1) % 3
            left = int(ends[n - 2]) - 1 - 22
            while left % 3 != frame:
                left += 1
            blocks.append((left, length - 1, 1))
        else:
            frame = (int(ends[n - 1]) - 1) % 3
            right = length - 1
            while right % 3 != frame:
                right -= 1
            blocks.append((int(ends[n - 2]) - 22 - 1, right, -1))
    else:                               # extension to right
        if extended_left:
            if not is_reverse:
                frame = (int(begins[n - 1]) - 1) % 3
                left = int(ends[n - 2]) - 1 - 22
                while left % 3 != frame:
                    left += 1
                blocks.append((left, length - 1, 1))
            else:
                frame = (int(ends[n - 1]) - 1) % 3
                right = length - 1
                while right % 3 != frame:
                    right -= 1
                blocks.append((int(ends[n - 2]) - 22 - 1, right, -1))
        else:
            if not is_reverse:
                # quirk preserved: begin, not begin-1 (reference :539)
                blocks.append((int(begins[n - 1]), length - 1, 1))
            else:
                frame = (int(ends[n - 1]) - 1) % 3
                right = length - 1
                while right % 3 != frame:
                    right -= 1
                blocks.append((int(begins[n - 1]) - 1, right, -1))
        if right_hash not in intergenic:
            intergenic.append(right_hash)

    return blocks


def reverse_complement(seq: str) -> str:
    """IUPAC reverse complement (reference SeqIterator::reverseComplement
    over the iRCT table, common.cpp:19-23)."""
    return "".join(_IRCT.get(c, ".") for c in reversed(seq))
