"""Build and load the port's CUDA kernels, at first use.

The kernels are compiled from the repository's own sources
(``graphsage_torch/csrc/*.cu``) with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/graphsage_torch/libgs_kernels-<hash>.so

The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a current build is reused.  ``nvcc``'s report
(``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside it as ``.log``.  Nothing here runs at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "aggregate.cu",)
BUILD_DIR = _PKG.parent / "build" / "graphsage_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entry points and their ctypes signatures (graphsage_torch/csrc):
# (dtype, device, embed, embed_stride, idx, mask, out, U, S, D, stream)
_AGG_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "gs_gather_mean": (_AGG_ARGS, ctypes.c_int),
    "gs_gather_max": (_AGG_ARGS, ctypes.c_int),
    "gs_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the CUDA "
        "toolkit is needed to build graphsage_torch's kernels")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgs_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a current build exists; return the .so."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never see
    # a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed (nvcc rc={proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernels' library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
