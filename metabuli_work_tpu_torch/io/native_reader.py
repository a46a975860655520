"""ctypes binding for the native batch sequence reader
(native/seqreader.cpp, built into build/torch_kernels/ at first use).

The native reader streams plain or gzip FASTA/FASTQ and fills padded
uint8 batch arrays (rows of 'N' past each read) directly, the layout the
device step consumes, so the host input stage does no per-read Python
work.  Names are cut at NAME_STRIDE - 1 bytes, and the bases beyond a
batch's row width are dropped while its length keeps the whole read
(classify/pipeline.Classifier._widen restores such reads).  When the
library cannot be built (no compiler or no zlib), available() is False
and classify reads with the Python reader (io/fasta.py).
"""

import ctypes

import numpy as np

from ..utils.build import build_native

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native("seqreader.cpp", "libseqreader.so",
                                       libs=("-lz",)))
        lib.sr_open.restype = ctypes.c_void_p
        lib.sr_open.argtypes = [ctypes.c_char_p]
        lib.sr_close.argtypes = [ctypes.c_void_p]
        lib.sr_next_batch.restype = ctypes.c_int
        lib.sr_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


class NativeBatchReader:
    """Iterate (names, seqs uint8 [n, max_len], lens int32 [n]) batches."""

    NAME_STRIDE = 128

    def __init__(self, path, batch_size=512, max_len=4096):
        self._lib = _load()
        self._h = self._lib.sr_open(str(path).encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.batch_size = batch_size
        self.max_len = max_len

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        B, L = self.batch_size, self.max_len
        seqs = np.empty((B, L), dtype=np.uint8)
        lens = np.empty(B, dtype=np.int32)
        names = np.zeros(B * self.NAME_STRIDE, dtype=np.uint8)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        n = self._lib.sr_next_batch(
            self._h, B, L, seqs.ctypes.data_as(pu8),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            names.ctypes.data_as(ctypes.c_char_p), self.NAME_STRIDE,
            ctypes.cast(None, pu8))            # no quality scores
        if n <= 0:
            self.close()
            raise StopIteration
        rows = names[:n * self.NAME_STRIDE].reshape(n, self.NAME_STRIDE)
        name_list = [bytes(r).split(b"\0", 1)[0].decode() for r in rows]
        return name_list, seqs[:n], lens[:n]

    def close(self):
        if self._h:
            self._lib.sr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
