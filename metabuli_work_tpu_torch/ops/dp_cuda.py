"""Fused path DP (rank + DP + blocked emission): CUDA kernel and its
plain torch version.

path_dp_blocked launches csrc/path_dp.cu on CUDA tensors and runs the
plain version, path_dp_blocked_ref, on CPU tensors; a CUDA tensor never
falls back to the plain version.  The kernel replaces the TPU kernel
metabuli_work_tpu/ops/dp_pallas.py::_dp_kernel (see the note at the top
of csrc/path_dp.cu for what bounds it on an H100 and how the design
answers that).

The kernel library is compiled by nvcc (sm_90a) at first use into the
package's build directory (utils/build.py) and bound with ctypes.
"""

import ctypes
import os
import shutil

import torch

from ..utils.build import REPO_ROOT, build_library
from . import dp_torch

SOURCE = os.path.join(REPO_ROOT, "metabuli_work_tpu_torch", "csrc",
                      "path_dp.cu")
_SMEM_LIMIT = 64 * 1024          # ring bytes per block kept on chip

# kernel launches by path_dp_blocked, and plain-version runs on CUDA
# tensors (only comparisons call the plain version there)
launches = 0
plain_cuda_calls = 0

_LIB = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA path DP kernel cannot be built")


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = build_library(
        [SOURCE], "libpath_dp.so",
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"])
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.path_dp_launch.argtypes = [P] * 9 + [I] * 12 + [P]
    lib.path_dp_launch.restype = I
    lib.path_dp_smem_bytes.argtypes = [I, I]
    lib.path_dp_smem_bytes.restype = ctypes.c_longlong
    _LIB = lib
    return lib


def path_dp_blocked_ref(sp_m, dna, rh, ham, pos, min_cons: int,
                        min_cons_euk: int, max_shift: int, kmer_format: int,
                        dyn_gap: bool, block_w: int, compact5: bool = True):
    """Plain torch version of the kernel: sort_candidates -> path_dp ->
    pack_paths_blocked on inputs already flipped so positions ascend,
    with the kernel's output contract (block_w slots per lane, empty
    slots 0 in every column)."""
    global plain_cuda_calls
    if sp_m.is_cuda:
        plain_cuda_calls += 1
    cap, G, W = sp_m.shape
    fields = {"sel": sp_m >= 0, "species": sp_m, "dna": dna, "rh": rh,
              "ham": ham, "pos": pos}
    f = dp_torch.sort_candidates(fields, fields["sel"], ham, dna)
    md = torch.where((f["species"] >> 30) & 1 != 0, min_cons_euk,
                     min_cons).to(torch.int32)
    out = dp_torch._path_dp_ascending(
        f["sel"], f["species"], f["dna"], f["rh"], f["ham"], f["pos"], md,
        max_shift, kmer_format, dyn_gap)
    cols, valid, over = dp_torch.pack_paths_blocked(out, block_w,
                                                    compact5=compact5)
    bw = cols.shape[1] // G
    if bw < block_w:                       # fewer candidate rows than slots
        C = cols.shape[0]
        pad = torch.zeros((C, (block_w - bw) * G), dtype=cols.dtype,
                          device=cols.device)
        cols = torch.cat([cols, pad], 1)
        valid = torch.cat([valid, torch.zeros((block_w - bw) * G,
                                              dtype=torch.bool,
                                              device=valid.device)])
    cols = torch.where(valid[None], cols, 0)
    return cols, valid, over


def path_dp_blocked(sp_m, dna, rh, ham, pos, min_cons: int,
                    min_cons_euk: int, max_shift: int, kmer_format: int,
                    dyn_gap: bool, block_w: int, compact5: bool = True):
    """Fused (rank + DP + blocked pack) over [cap, G, W] int32 candidate
    tensors, already FLIPPED so positions ascend along W in every lane.

    sp_m: species with the euk flag in bit 30, -1 where no candidate.
    Returns (cols int32 [C, block_w * G] slot-major, valid bool
    [block_w * G], blk_over int32 scalar tensor); C = 5 with compact5,
    else 7.  Valid slots equal pack_paths_blocked(path_dp(
    sort_candidates(...))) lane by lane; empty slots hold 0.
    """
    global launches
    ins = (sp_m, dna, rh, ham, pos)
    dev = sp_m.device
    if dev.type == "cpu":
        return path_dp_blocked_ref(*ins, min_cons, min_cons_euk, max_shift,
                                   kmer_format, dyn_gap, block_w, compact5)
    if dev.type != "cuda":
        raise ValueError(f"path_dp_blocked: unsupported device {dev}")
    for a in ins:
        if a.device != dev or a.dtype != torch.int32 \
                or a.shape != sp_m.shape or not a.is_contiguous():
            raise ValueError("path_dp_blocked: inputs must be contiguous "
                             "int32 tensors of one shape on one device")
    cap, G, W = sp_m.shape
    if cap < 1 or G < 1 or max_shift < 1 or block_w < 1:
        raise ValueError(f"path_dp_blocked: unsupported shape "
                         f"cap={cap} G={G} max_shift={max_shift} "
                         f"block_w={block_w}")
    if compact5 and G > (1 << 16):
        raise ValueError("path_dp_blocked: compact5 needs G <= 65536")
    lib = build()
    n_cols = 5 if compact5 else 7
    smem = int(lib.path_dp_smem_bytes(cap, max_shift))
    in_smem = smem <= _SMEM_LIMIT
    with torch.cuda.device(dev):
        cols = torch.empty((n_cols, block_w, G), dtype=torch.int32,
                           device=dev)
        valid = torch.empty((block_w, G), dtype=torch.bool, device=dev)
        over = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = None if in_smem else torch.empty(
            G * smem // 4, dtype=torch.int32, device=dev)
        threads = min(256, max(32, -(-cap // 32) * 32))
        err = lib.path_dp_launch(
            *(a.data_ptr() for a in ins), cols.data_ptr(), valid.data_ptr(),
            over.data_ptr(), scratch.data_ptr() if scratch is not None else 0,
            cap, G, W, max_shift, block_w, int(kmer_format), int(dyn_gap),
            int(min_cons), int(min_cons_euk), int(compact5), int(in_smem),
            threads, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"path_dp kernel launch failed: CUDA error {err}")
    launches += 1
    return cols.reshape(n_cols, block_w * G), valid.reshape(-1), over[0]
