"""Fused 6-frame query extraction on the card: the CUDA kernel
csrc/extract.cu (one launch for a batch of one or two mates) and its
wrapper.

encode_torch.extract_batch and models/flagship.extract_queries_step
launch it for CUDA tensors and run their plain torch versions
(encode_torch.extract_batch_ref, flagship.extract_queries_step_ref) for
CPU tensors; a CUDA tensor never falls back to the plain version.  The
kernel reads the reverse frames from the forward rows, so it takes no
right-aligned copy of the reads.  The library is compiled by nvcc
(sm_90a) at first use, in parallel with the package's other CUDA
libraries (utils/build.cuda_libraries), and bound with ctypes.
"""

import ctypes

import numpy as np
import torch

from ..utils.build import cuda_libraries
from . import encode_torch

# kernel launches (one a call of extract_batch or extract_queries on
# CUDA tensors with at least one read)
launches = 0

_LIB = None
# AANUM of each 2-bit codon: forward strand, then reverse complement
_TABLES = np.concatenate([encode_torch._TBL_FWD, encode_torch._TBL_RC]) \
    .astype(np.uint8).tobytes()


def build():
    """Compile (if needed, with the package's other CUDA libraries) and
    load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_libraries()["extract"]
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.extract_launch.argtypes = ([P, P, I, I, I] * 2 + [I] * 7
                                       + [ctypes.c_char_p] + [P] * 7)
        lib.extract_launch.restype = I
        _LIB = lib
    return _LIB


def _on_card(reads):
    """The reads' device, or ValueError when it is not a card."""
    if reads.device.type != "cuda":
        raise ValueError(f"extract kernel: unsupported device {reads.device}")
    return reads.device


def _checked(reads, lens, dev):
    """(reads, int32 lengths) as the kernel takes them, or ValueError."""
    if reads.device != dev or reads.dtype != torch.uint8 \
            or reads.dim() != 2 or not reads.is_contiguous():
        raise ValueError("extract kernel: reads must be a contiguous uint8 "
                         "[B, L] tensor on the card")
    lens = lens.to(torch.int32).contiguous()
    if lens.device != dev or lens.shape != (reads.shape[0],):
        raise ValueError("extract kernel: lengths must be a [B] tensor on "
                         "the reads' device")
    return reads, lens


def _launch(parts, k, kmer_format, aa_only, syncmer, smer_len, compact,
            outs, win_over):
    """One launch over parts = [(reads, int32 lengths, W, w_out)] (one or
    two, the same B) into the flat outs (qk, qp, qf, qs, qv; qf and qs
    None for the unflattened layout)."""
    global launches
    B = parts[0][0].shape[0]
    if B == 0:
        return
    if k != 8 and not (k == 12 and aa_only):
        raise ValueError(f"extract kernel: k {k} (takes 8, or 12 with "
                         f"aa_only)")
    if syncmer and not 1 <= smer_len <= k:
        raise ValueError(f"extract kernel: smer_len {smer_len} outside "
                         f"1..{k}")
    ptr = lambda t: t.data_ptr() if t is not None else None
    args = []
    no_part = (None, None, 0, 0)
    for reads, lens, W, w_out in parts + [no_part] * (2 - len(parts)):
        args += [ptr(reads), ptr(lens),
                 reads.shape[1] if reads is not None else 0, W, w_out]
    dev = parts[0][0].device
    err = build().extract_launch(
        *args, B, k, kmer_format, int(aa_only), int(syncmer), smer_len,
        int(compact), _TABLES, *(ptr(t) for t in outs), ptr(win_over),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"extract kernel launch failed: CUDA error {err}")
    launches += 1


def extract_batch(reads, lengths, *, syncmer: bool, smer_len: int, k: int,
                  aa_only: bool, kmer_format: int):
    """encode_torch.extract_batch on CUDA tensors: (kmers int64, pos
    int32, valid bool), each [B, 6, W]."""
    dev = _on_card(reads)
    with torch.cuda.device(dev):
        reads, lens = _checked(reads, lengths, dev)
        B = reads.shape[0]
        W = encode_torch.max_windows(reads.shape[1], k)
        kmers = torch.empty((B, 6, W), dtype=torch.int64, device=dev)
        pos = torch.empty((B, 6, W), dtype=torch.int32, device=dev)
        valid = torch.empty((B, 6, W), dtype=torch.bool, device=dev)
        _launch([(reads, lens, W, W)], k, kmer_format, aa_only, syncmer,
                smer_len, False, (kmers, pos, None, None, valid), None)
    return kmers, pos, valid


def extract_queries(parts, *, syncmer: bool, smer_len: int,
                    kmer_format: int, compact: bool):
    """flagship.extract_queries_step on CUDA tensors.  parts = [(reads,
    lengths, w_out)], mate 1 then mate 2 (same B), w_out the compacted
    slots a frame with `compact`, else the part's window count.  Returns
    (qk, qp, qf, qs, qv, shapes, win_over) as the plain version does."""
    dev = _on_card(parts[0][0])
    with torch.cuda.device(dev):
        # the extract stage's first device operation: the kernel, which
        # the profiler sees no launch of, follows it on the stream
        win_over = torch.zeros((), dtype=torch.int32, device=dev)
        checked = []
        for reads, lens, w_out in parts:
            reads, lens = _checked(reads, lens, dev)
            checked.append((reads, lens,
                            encode_torch.max_windows(reads.shape[1]), w_out))
        B = checked[0][0].shape[0]
        if any(p[0].shape[0] != B for p in checked):
            raise ValueError("extract kernel: the mates differ in batch size")
        shapes = [(B, 6, w_out) for _, _, _, w_out in checked]
        n = sum(B * 6 * w for _, _, _, w in checked)
        outs = (torch.empty(n, dtype=torch.int64, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))
        _launch(checked, 8, kmer_format, False, syncmer, smer_len, compact,
                outs, win_over)
    return (*outs, shapes, win_over)
