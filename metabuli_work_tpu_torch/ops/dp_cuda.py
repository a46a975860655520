"""Fused path DP (rank + DP + blocked emission): CUDA kernels and their
plain torch version.

path_dp_blocked launches a CUDA kernel on CUDA tensors and runs the
plain version, path_dp_blocked_ref, on CPU tensors; a CUDA tensor never
falls back to the plain version.  Two kernels replace the TPU kernel
metabuli_work_tpu/ops/dp_pallas.py::_dp_kernel, chosen by cap alone:

- "warp" (csrc/path_dp_warp.cu) for cap <= WARP_MAX_CAP: a lane's
  candidates are threads of one warp, several lanes per warp, window
  tiles staged by cp.async, no block barriers;
- "block" (csrc/path_dp.cu) for larger caps, up to MAX_CAP: one warp a
  lane (a block is one warp), live candidates compacted, predecessors
  looked up by species in a hash table of each ring window, tiles staged
  by cp.async, shared memory sized to the cap; the ring goes to a global
  scratch slice of each resident block only where it cannot fit (caps of
  about a thousand and more).

The notes at the top of each source say what bounds it on an H100 and
how its design answers that.  Each kernel library is compiled by nvcc
(sm_90a) at first use into the package's build directory, in parallel
with the package's other CUDA libraries (utils/build.cuda_libraries),
and bound with ctypes.
"""

import ctypes

import torch

from ..utils.build import cuda_libraries
from . import dp_torch

WARP_MAX_CAP = 32                # a lane's candidates fit one warp
MAX_CAP = 4096                   # block variant: 12-bit entry indices
MAX_SHIFT = 8                    # 24-bit DNA codes shift by <= 8 codons

# kernel launches by path_dp_blocked (all, and per variant), and
# plain-version runs on CUDA tensors (only comparisons call the plain
# version there)
launches = 0
warp_launches = 0
block_launches = 0
plain_cuda_calls = 0

_LIBS = None


def variant(cap: int) -> str:
    """The kernel that path_dp_blocked launches for this cap."""
    return "warp" if cap <= WARP_MAX_CAP else "block"


def build():
    """Compile (if needed, with the package's other CUDA libraries) and
    load the kernel libraries; returns {"warp": lib, "block": lib}."""
    global _LIBS
    if _LIBS is not None:
        return _LIBS
    built = cuda_libraries()
    libs = {v: built[f"path_dp_{v}"] for v in ("warp", "block")}
    P, I = ctypes.c_void_p, ctypes.c_int
    L = ctypes.c_longlong
    blk = libs["block"]
    blk.path_dp_block_launch.argtypes = [P] * 9 + [L] + [I] * 10 + [P]
    blk.path_dp_block_launch.restype = I
    blk.path_dp_block_scratch_bytes.argtypes = [I, I]
    blk.path_dp_block_scratch_bytes.restype = L
    blk.path_dp_block_plan.argtypes = [I, I, ctypes.POINTER(L)]
    blk.path_dp_block_plan.restype = I
    warp = libs["warp"]
    warp.path_dp_warp_launch.argtypes = [P] * 8 + [I] * 10 + [P]
    warp.path_dp_warp_launch.restype = I
    _LIBS = libs
    return libs


def block_plan(cap: int, max_shift: int):
    """How the block variant lays out a lane at (cap, max_shift): (ring
    in shared memory, dynamic shared-memory bytes a block, windows a
    staged tile).  Builds the library."""
    out = (ctypes.c_longlong * 2)()
    in_smem = build()["block"].path_dp_block_plan(cap, max_shift, out)
    return bool(in_smem), int(out[0]), int(out[1])


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
    ins = (sp_m, dna, rh, ham, pos)
    dev = sp_m.device
    if dev.type == "cpu":
        return path_dp_blocked_ref(*ins, min_cons, min_cons_euk, max_shift,
                                   kmer_format, dyn_gap, block_w, compact5)
    return _launch(variant(sp_m.shape[0]), ins, min_cons, min_cons_euk,
                   max_shift, kmer_format, dyn_gap, block_w, compact5)


def _launch(which, ins, min_cons, min_cons_euk, max_shift, kmer_format,
            dyn_gap, block_w, compact5):
    """Launches kernel `which` ("warp" or "block") on CUDA tensors and
    counts the launch; raises on bad inputs or a failed launch.  Only
    path_dp_blocked picks the variant (by cap); a caller naming one
    directly is a benchmark of the two kernels on one input."""
    global launches, warp_launches, block_launches
    sp_m = ins[0]
    dev = sp_m.device
    if dev.type != "cuda":
        raise ValueError(f"path_dp_blocked: unsupported device {dev}")
    for a in ins:
        if a.device != dev or a.dtype != torch.int32 \
                or a.shape != sp_m.shape or not a.is_contiguous():
            raise ValueError("path_dp_blocked: inputs must be contiguous "
                             "int32 tensors of one shape on one device")
    cap, G, W = sp_m.shape
    if cap < 1 or G < 1 or not 1 <= max_shift <= MAX_SHIFT or block_w < 1 \
            or cap > (WARP_MAX_CAP if which == "warp" else MAX_CAP):
        raise ValueError(f"path_dp_blocked: unsupported shape for the "
                         f"{which} kernel: cap={cap} G={G} "
                         f"max_shift={max_shift} block_w={block_w}")
    if compact5 and G > (1 << 16):
        raise ValueError("path_dp_blocked: compact5 needs G <= 65536")
    lib = build()[which]
    n_cols = 5 if compact5 else 7
    opts = (int(kmer_format), int(dyn_gap), int(min_cons), int(min_cons_euk),
            int(compact5))
    with torch.cuda.device(dev):
        cols = torch.empty((n_cols, block_w, G), dtype=torch.int32,
                           device=dev)
        valid = torch.empty((block_w, G), dtype=torch.bool, device=dev)
        over = torch.zeros(1, dtype=torch.int32, device=dev)
        ptrs = [a.data_ptr() for a in ins] + [cols.data_ptr(),
                                              valid.data_ptr(),
                                              over.data_ptr()]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "warp":
            err = lib.path_dp_warp_launch(*ptrs, cap, G, W, max_shift,
                                          block_w, *opts, stream)
        else:
            # a ring a resident block when the ring cannot stay on chip
            n_scratch = int(lib.path_dp_block_scratch_bytes(cap, max_shift))
            if n_scratch < 0:
                raise RuntimeError(f"path_dp block kernel: no plan for "
                                   f"cap={cap} max_shift={max_shift} "
                                   f"({n_scratch})")
            scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev) \
                if n_scratch else None
            err = lib.path_dp_block_launch(
                *ptrs, scratch.data_ptr() if scratch is not None else 0,
                n_scratch, cap, G, W, max_shift, block_w, *opts, stream)
    if err != 0:
        raise RuntimeError(f"path_dp {which} kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    if which == "warp":
        warp_launches += 1
    else:
        block_launches += 1
    return cols.reshape(n_cols, block_w * G), valid.reshape(-1), over[0]
