"""The redundancy step on the card: the CUDA kernel csrc/redundancy.cu
(one cooperative launch a call) and its wrapper.

models/flagship.redundancy_counts launches it for CUDA tensors; CPU
tensors run the plain torch version (flagship.redundancy_counts_ref).  A
CUDA tensor never falls back to the plain version.  The library is
compiled by nvcc (sm_90a) at first use, in parallel with the package's
other CUDA libraries (utils/build.cuda_libraries), and bound with ctypes.
"""

import ctypes

import torch

from ..utils.build import cuda_libraries

# kernel launches (one a call on CUDA tensors)
launches = 0

MAX_PARTS = 4           # redundancy::kMaxParts
_MAX_BLOCKS = 4096      # block-count scratch words; the grid stays below
_LIB = None


def build():
    """Compile (if needed, with the package's other CUDA libraries) and
    load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_libraries()["redundancy"]
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.redundancy_launch.argtypes = [
            P, P, P, P, L, I, P, P, P, L, P, I, L, L, P, L, P, P, I, L, P, L,
            P, L, P]
        lib.redundancy_launch.restype = I
        _LIB = lib
    return _LIB


def _checked(t, dtype, dev, what, shape):
    """t as the kernel takes it (contiguous, on dev, of dtype and shape),
    or ValueError."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"redundancy kernel: {what} must be a contiguous "
                         f"{dtype} tensor {shape} on {dev}")
    return t


def redundancy(sel, species, ham, ef, q_pos, q_sids, best_sp, euler, depth,
               lift, *, dna_shift: int, n_quot: int, part_w: tuple = (),
               out_w: int = 0):
    """flagship.redundancy_counts on CUDA tensors: sel bool and species,
    ham, ef int32, each [cap, N]; q_pos, q_sids int32 [N]; best_sp int32
    [B + 1]; euler int32 [E]; depth int32 [T]; lift int32 [levels, T].
    Returns the [2, 1 + width] int32 result of the plain version, equal
    on column 0 and on the first min(count, width) pairs; the columns
    past the count are not written.  Raises ValueError before any launch
    for a tensor of another shape, dtype or layout, options out of range
    (dna_shift, n_quot >= 1, out_w >= 0, at most MAX_PARTS part widths
    >= 1), or tensors off the card."""
    global launches
    if sel.dim() != 2 or best_sp.dim() != 1 or best_sp.shape[0] < 1 \
            or euler.dim() != 1 or euler.shape[0] < 1 or lift.dim() != 2 \
            or not 1 <= lift.shape[0] <= 62 or lift.shape[1] < 1:
        raise ValueError("redundancy kernel: sel must be [cap, N], best_sp "
                         "[B + 1], euler [E >= 1] and lift [1-62, T >= 1]")
    if dna_shift < 1 or n_quot < 1 or out_w < 0 or len(part_w) > MAX_PARTS \
            or any(w < 1 for w in part_w):
        raise ValueError(f"redundancy kernel: dna_shift and n_quot must be "
                         f">= 1, out_w >= 0, and part_w at most {MAX_PARTS} "
                         f"widths >= 1")
    dev = sel.device
    cap, n = sel.shape
    levels, n_nodes = lift.shape
    i32 = torch.int32
    _checked(sel, torch.bool, dev, "sel", (cap, n))
    for t, what in ((species, "species"), (ham, "ham"), (ef, "ef")):
        _checked(t, i32, dev, what, (cap, n))
    _checked(q_pos, i32, dev, "q_pos", (n,))
    _checked(q_sids, i32, dev, "q_sids", (n,))
    _checked(best_sp, i32, dev, "best_sp", tuple(best_sp.shape))
    _checked(euler, i32, dev, "euler", tuple(euler.shape))
    _checked(depth, i32, dev, "depth", (n_nodes,))
    _checked(lift, i32, dev, "lift", (levels, n_nodes))
    if dev.type != "cuda":
        raise ValueError(f"redundancy kernel: unsupported device {dev}")
    with torch.cuda.device(dev):
        b = best_sp.shape[0] - 1
        n_groups = b * n_quot
        width = out_w if 0 < out_w < n_groups else n_groups
        out = torch.empty((2, 1 + width), dtype=i32, device=dev)
        scratch = torch.empty(2 * n_groups + _MAX_BLOCKS, dtype=i32,
                              device=dev)
        widths = (ctypes.c_longlong * MAX_PARTS)(*part_w)
        err = build().redundancy_launch(
            sel.data_ptr(), species.data_ptr(), ham.data_ptr(),
            ef.data_ptr(), n, cap, q_pos.data_ptr(), q_sids.data_ptr(),
            best_sp.data_ptr(), b, widths, len(part_w), dna_shift, n_quot,
            euler.data_ptr(), euler.shape[0], depth.data_ptr(),
            lift.data_ptr(), levels, n_nodes, scratch.data_ptr(),
            _MAX_BLOCKS, out.data_ptr(), width,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"redundancy kernel launch failed: CUDA error {err}")
        launches += 1
    return out
