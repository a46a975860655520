"""Low-complexity masking (tantan stage).

The reference masks repeats with tantan before k-mer extraction
(SeqIterator::maskLowComplexityRegions, src/commons/SeqIterator.cpp:
154-175; mask defaults: build on, classify off — workflow/build.cpp:
21-22, workflow/classify.cpp).  The primary masker here is a native C++
implementation of the tantan repeat HMM (native/tantan_mask.cpp,
Frith 2011 algorithm with the reference's fixed options); positions
whose posterior repeat probability exceeds mask_prob become 'N' so
downstream extraction skips them.  A vectorized DUST-style masker
remains as a pure-python fallback when the native library is absent.
"""

import ctypes

import numpy as np

from ..utils.build import build_native

_tantan = None


def _load_tantan():
    global _tantan
    if _tantan is not None:
        return _tantan
    try:
        so = build_native("tantan_mask.cpp", "libtantan.so",
                          ("-O3", "-pthread"))
        lib = ctypes.CDLL(so)
        lib.tantan_mask.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64, ctypes.c_double]
        lib.tantan_mask.restype = None
        _tantan = lib
    except Exception:
        _tantan = False
    return _tantan


def mask_low_complexity_tantan(seq: str, mask_prob: float = 0.9):
    """Native tantan-HMM masking; returns None if the library is absent."""
    lib = _load_tantan()
    if not lib:
        return None
    buf = np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8).copy()
    lib.tantan_mask(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    len(buf), float(mask_prob))
    return buf.tobytes().decode("ascii")

_WINDOW = 64
# DUST score threshold scaled from mask_prob: higher prob -> mask less.
_BASE_THRESHOLD = 2.0


def mask_low_complexity(seq: str, mask_prob: float = 0.9) -> str:
    """Mask repeats: native tantan HMM if built, DUST-style otherwise."""
    out = mask_low_complexity_tantan(seq, mask_prob)
    if out is not None:
        return out
    return _mask_dust(seq, mask_prob)


def mask_batch_rows(arr: np.ndarray, lens, mask_prob: float = 0.9):
    """Masking of padded uint8 read rows [B, L], each on its first
    ``lens[i]`` bytes (the native batch reader's rows): the native
    tantan HMM in place, the DUST masker row by row when the library is
    absent.  Returns ``arr`` (a contiguous copy when it was not)."""
    lib = _load_tantan()
    arr = np.ascontiguousarray(arr)
    lens = np.asarray(lens)
    if lib:
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        step = arr.strides[0]
        base = arr.ctypes.data
        for i in range(arr.shape[0]):
            L = int(min(lens[i], arr.shape[1]))
            if L:
                lib.tantan_mask(ctypes.cast(base + i * step, pu8), L,
                                float(mask_prob))
        return arr
    for i in range(arr.shape[0]):
        L = int(min(lens[i], arr.shape[1]))
        if L:
            s = arr[i, :L].tobytes().decode("ascii", "replace")
            arr[i, :L] = np.frombuffer(
                _mask_dust(s, mask_prob).encode("ascii", "replace"),
                np.uint8)
    return arr


def _mask_dust(seq: str, mask_prob: float = 0.9) -> str:
    n = len(seq)
    if n < _WINDOW:
        return seq
    arr = np.frombuffer(seq.upper().encode("ascii", "replace"), dtype=np.uint8)
    code = np.full(n, 255, dtype=np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[arr == ch] = i
    valid = code < 4

    # triplet ids over valid positions
    if n < 3:
        return seq
    t = code[:-2].astype(np.int32) * 16 + code[1:-1].astype(np.int32) * 4 + code[2:].astype(np.int32)
    t_valid = valid[:-2] & valid[1:-1] & valid[2:]
    t = np.where(t_valid, t, 64)

    # windowed triplet-count score: sum c*(c-1)/2 over 64 triplet types
    counts = np.zeros((65, n - 2), dtype=np.int32)
    onehot = np.zeros((65, n - 2), dtype=np.int32)
    onehot[t, np.arange(n - 2)] = 1
    np.cumsum(onehot, axis=1, out=counts)
    w = _WINDOW - 2
    if counts.shape[1] <= w:
        return seq
    win = counts[:64, w:] - counts[:64, :-w]
    score = (win * (win - 1) // 2).sum(axis=0) / max(w - 1, 1)

    thr = _BASE_THRESHOLD / max(1.0 - mask_prob, 0.05) * 0.5
    bad = score > thr
    if not bad.any():
        return seq
    mask = np.zeros(n, dtype=bool)
    idx = np.nonzero(bad)[0]
    for start in idx:
        mask[start : start + _WINDOW] = True
    out = arr.copy()
    out[mask] = ord("N")
    return out.tobytes().decode("ascii")
