"""The index probe on the card: the CUDA kernel csrc/probe.cu (one launch
a probe of a query batch) and its wrapper.

match_torch.match_kmers_quad launches it for CUDA tensors, and
models/flagship.probe_range_step launches it in fold mode (the range's
candidates added into the sweep's accumulators in place); CPU tensors
run the plain torch version (match_torch.match_kmers_quad_ref).  A CUDA
tensor never falls back to the plain version.  The library
is compiled by nvcc (sm_90a) at first use, in parallel with the
package's other CUDA libraries (utils/build.cuda_libraries), and bound
with ctypes.
"""

import ctypes

import torch

from ..utils.build import cuda_libraries
from .genetic_code import HAMMING_TABLE

# kernel launches (one a probe of a non-empty query batch on CUDA tensors)
launches = 0

_LIB = None
_TABLE = HAMMING_TABLE.astype("uint8").tobytes()
_FIELDS = ("hamming", "rh", "taxid", "species", "dna_enc")


def build():
    """Compile (if needed, with the package's other CUDA libraries) and
    load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_libraries()["probe"]
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_launch.argtypes = ([P, P, P, L, P, L, L, P, L]
                                     + [I] * 5 + [ctypes.c_char_p, I]
                                     + [P] * 8)
        lib.probe_launch.restype = I
        _LIB = lib
    return _LIB


def _checked(t, dtype, dev, what, shape=None):
    """t as the kernel takes it (contiguous, on dev, of dtype), or
    ValueError."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"probe kernel: {what} must be a contiguous "
                         f"{dtype} tensor{'' if shape is None else f' {shape}'}"
                         f" on {dev}")
    return t


def probe(q_kmers, q_frames, q_valid, db_quad, hash_table, *, cap: int,
          kmer_format: int, log2_rows: int, chain: int, m: int, acc=None):
    """match_kmers_quad on CUDA tensors with the hash: q_kmers int64,
    q_frames int32, q_valid bool, each [N]; db_quad any int32 layout of
    match_kmers_quad (read as flat 16-byte entries, of which the first
    `m` exist); hash_table int32 [R, row_u32].  Returns the dict of
    match_kmers_quad, with 0 in the five value fields wherever sel is
    false.  With `acc` (flagship.new_accumulators(cap, N)) the kernel
    folds the candidates into it instead (sel ORed, the fields and the
    overflow added where sel) and returns acc."""
    global launches
    dev = q_kmers.device
    if dev.type != "cuda":
        raise ValueError(f"probe kernel: unsupported device {dev}")
    n = q_kmers.shape[0]
    with torch.cuda.device(dev):
        # the probe stage's first device operation: the kernel, which the
        # profiler sees no launch of, follows it on the stream
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        qk = _checked(q_kmers, torch.int64, dev, "q_kmers", (n,))
        qf = _checked(q_frames, torch.int32, dev, "q_frames", (n,))
        qv = _checked(q_valid, torch.bool, dev, "q_valid", (n,))
        ent = _checked(db_quad, torch.int32, dev, "db_quad")
        ht = _checked(hash_table, torch.int32, dev, "hash_table")
        if ent.numel() < 4 or ent.numel() % 4 or ent.data_ptr() % 16 \
                or ht.dim() != 2 or ht.shape[1] < 3:
            raise ValueError("probe kernel: db_quad must hold whole 16-byte "
                             "entries at a 16-byte boundary, and hash_table "
                             "be [R, row_u32 >= 3]")
        if acc is None:
            out = {"sel": torch.empty((cap, n), dtype=torch.bool, device=dev)}
            for k in _FIELDS:
                out[k] = torch.empty((cap, n), dtype=torch.int32, device=dev)
        else:
            out = acc
            _checked(acc["sel"], torch.bool, dev, "acc['sel']", (cap, n))
            for k in _FIELDS:
                _checked(acc[k], torch.int32, dev, f"acc[{k!r}]", (cap, n))
        if n:
            err = build().probe_launch(
                qk.data_ptr(), qf.data_ptr(), qv.data_ptr(), n,
                ent.data_ptr(), ent.numel() // 4, m, ht.data_ptr(),
                ht.shape[0], ht.shape[1], log2_rows, chain, cap,
                kmer_format, _TABLE, int(acc is not None),
                *(out[k].data_ptr() for k in ("sel",) + _FIELDS),
                overflow.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f"probe kernel launch failed: CUDA error {err}")
            launches += 1
        if acc is None:
            out["overflow"] = overflow
        else:
            acc["overflow"] += overflow
    return out
