"""ctypes binding for the native host-scoring loops (native/hostscore.cpp,
compiled into the package's build directory, utils/build.py).

Falls back to the numpy implementations in taxonomer_vec when no
toolchain is available (available() returns False).
"""

import ctypes

import numpy as np

from ..utils.build import build_native

_LIB = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = build_native("hostscore.cpp", "libhostscore.so")
    lib = ctypes.CDLL(so)
    lib.combine_paths_batch.restype = None
    lib.combine_paths_batch.argtypes = [
        ctypes.c_int64, _I64P, _I64P,
        _I32P, _I32P, _F32P, _I32P, _I32P, _I32P, _F32P,
    ]
    lib.count_pairs.restype = ctypes.c_int64
    lib.count_pairs.argtypes = [ctypes.c_int64, _I32P, _I32P,
                                _I32P, _I32P, _I32P]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _i32(a):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(_I32P)


def combine_paths_batch(paths, starts, cnts):
    """Greedy path combination per run; returns f32 score sums [n_runs].

    paths: dict with start/end/score/hamming/rh_start/rh_end flat arrays
    (any order within a run — the native code applies the reference's
    (-score, hamming, -start) sort itself).
    """
    lib = _load()
    n_runs = len(starts)
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    cnts64 = np.ascontiguousarray(cnts, dtype=np.int64)
    ps, ps_p = _i32(paths["start"])
    pe, pe_p = _i32(paths["end"])
    sc = np.ascontiguousarray(paths["score"], dtype=np.float32)
    ph, ph_p = _i32(paths["hamming"])
    rs, rs_p = _i32(paths["rh_start"])
    re, re_p = _i32(paths["rh_end"])
    out = np.empty(n_runs, dtype=np.float32)
    lib.combine_paths_batch(
        n_runs,
        starts64.ctypes.data_as(_I64P), cnts64.ctypes.data_as(_I64P),
        ps_p, pe_p, sc.ctypes.data_as(_F32P), ph_p, rs_p, re_p,
        out.ctypes.data_as(_F32P))
    return out


def count_pairs(rid, tax):
    """Unique (rid, taxid) combinations with multiplicities."""
    lib = _load()
    n = len(rid)
    rid, rid_p = _i32(rid)
    tax, tax_p = _i32(tax)
    out_rid = np.empty(n, dtype=np.int32)
    out_tax = np.empty(n, dtype=np.int32)
    out_cnt = np.empty(n, dtype=np.int32)
    m = lib.count_pairs(n, rid_p, tax_p,
                        out_rid.ctypes.data_as(_I32P),
                        out_tax.ctypes.data_as(_I32P),
                        out_cnt.ctypes.data_as(_I32P))
    return out_rid[:m], out_tax[:m], out_cnt[:m]
