"""Build directory for the package's compiled libraries.

Host helpers (the repo's ``native/*.cpp``) and CUDA kernels
(``csrc/*.cu``) are compiled at first use into ``build/torch_kernels/``
at the repo root, which git ignores; the sources in ``native/`` and
their prebuilt libraries there are only read, never rewritten.  Each
library is written to a temporary name and renamed into place, so
concurrent first uses (test workers) never load a half-written file.
"""

import os
import subprocess
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NATIVE_DIR = os.path.join(REPO_ROOT, "native")


def build_library(sources, lib_name, cmd_prefix, deps=()):
    """Compile `sources` into BUILD_DIR/lib_name unless a copy newer than
    the sources and `deps` (headers they include) exists; returns the
    library path.  cmd_prefix is the compiler and its flags; "-o <tmp>"
    and the sources are appended.  Raises RuntimeError with the
    compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, lib_name)
    newest = max(os.path.getmtime(s) for s in [*sources, *deps])
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp_", suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run(list(cmd_prefix) + ["-o", tmp] + list(sources),
                           capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"compiler not found: {e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build of {lib_name} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build_native(src_name, lib_name, extra_flags=()):
    """g++ build of one of the repo's native/*.cpp host helpers."""
    src = os.path.join(NATIVE_DIR, src_name)
    return build_library([src], lib_name,
                         ["g++", "-O2", "-Wall", "-shared", "-fPIC",
                          *extra_flags])
