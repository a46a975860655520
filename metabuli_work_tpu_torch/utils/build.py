"""Build directory for the package's compiled libraries.

Host helpers (the repo's ``native/*.cpp``) and CUDA kernels
(``csrc/*.cu``) are compiled at first use into ``build/torch_kernels/``
at the repo root, which git ignores; the sources in ``native/`` and
their prebuilt libraries there are only read, never rewritten.  Each
library is written to a temporary name and renamed into place, so
concurrent first uses (test workers) never load a half-written file.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NATIVE_DIR = os.path.join(REPO_ROOT, "native")
CSRC_DIR = os.path.join(REPO_ROOT, "metabuli_work_tpu_torch", "csrc")

# the package's CUDA kernel libraries: name -> (source, headers it
# includes), under CSRC_DIR; each is built into lib<name>.so
CUDA_LIBRARIES = {
    "path_dp_block": ("path_dp.cu", ["path_dp_common.cuh"]),
    "path_dp_warp": ("path_dp_warp.cu", ["path_dp_common.cuh"]),
    "extract": ("extract.cu", []),
    "probe": ("probe.cu", []),
    "redundancy": ("redundancy.cu", []),
}
_cuda_libs = None
_cuda_lock = threading.Lock()


def build_library(sources, lib_name, cmd_prefix, deps=(), libs=()):
    """Compile `sources` into BUILD_DIR/lib_name unless a copy newer than
    the sources and `deps` (headers they include) exists; returns the
    library path.  cmd_prefix is the compiler and its flags; "-o <tmp>",
    the sources and then `libs` (link flags such as "-lz", which must
    follow the objects that need them) are appended.  Raises
    RuntimeError with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, lib_name)
    newest = max(os.path.getmtime(s) for s in [*sources, *deps])
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp_", suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run(list(cmd_prefix) + ["-o", tmp] + list(sources)
                           + list(libs), capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"compiler not found: {e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build of {lib_name} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build_native(src_name, lib_name, extra_flags=(), libs=()):
    """g++ build of one of the repo's native/*.cpp host helpers."""
    src = os.path.join(NATIVE_DIR, src_name)
    return build_library([src], lib_name,
                         ["g++", "-O2", "-Wall", "-shared", "-fPIC",
                          *extra_flags], libs=libs)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def cuda_libraries():
    """The CUDA_LIBRARIES, compiled by nvcc (sm_90a) at first use, all at
    once in parallel (a first run waits for the slowest build, not for
    their sum), and loaded with ctypes: {name: CDLL}.  The callers
    (ops/dp_cuda.py, ops/encode_cuda.py, ops/match_cuda.py,
    ops/redundancy_cuda.py) declare
    their functions' types."""
    global _cuda_libs
    with _cuda_lock:
        if _cuda_libs is None:
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "--fmad=false", "-shared",
                   "-Xcompiler", "-fPIC"]
            with ThreadPoolExecutor(len(CUDA_LIBRARIES)) as ex:
                futs = {name: ex.submit(
                    build_library, [os.path.join(CSRC_DIR, src)],
                    f"lib{name}.so", cmd,
                    deps=[os.path.join(CSRC_DIR, h) for h in headers])
                    for name, (src, headers) in CUDA_LIBRARIES.items()}
                _cuda_libs = {name: ctypes.CDLL(f.result())
                              for name, f in futs.items()}
        return _cuda_libs
