"""Build and load the port's CUDA kernels, at first use.

Each kernel source (``graphsage_torch/csrc/*.cu``) is compiled with ``nvcc``
into a shared library of its own with a plain C interface, loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/graphsage_torch/libgs_<name>-<hash>.so

All sources are compiled at once, one ``nvcc`` process each, started
together.  A library's name carries a hash of its source and the flags, so
an edited source is rebuilt and a current build is reused.  ``nvcc``'s
report (``-Xptxas -v``: registers, shared memory and spills per kernel) is
kept beside each library as ``.log``.  Nothing here runs at import; a failed
build raises.
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
SOURCES = {
    "aggregate": _PKG / "csrc" / "aggregate.cu",
    "sddmm": _PKG / "csrc" / "sddmm.cu",
    "gather": _PKG / "csrc" / "gather.cu",
    "scatter": _PKG / "csrc" / "scatter.cu",
    "pretransform": _PKG / "csrc" / "pretransform.cu",
}
BUILD_DIR = _PKG.parent / "build" / "graphsage_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entry points of each library and their ctypes signatures
# aggregate: (dtype, device, embed, embed_stride, idx, mask, out, U, S,
#             D, unit, lanes, kc, stream)
_AGG_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# max backward: (dtype, device, embed, embed_stride, idx, mask, out, g,
#                contrib, U, S, D, unit, lanes, kc, stream)
_MAX_BWD_ARGS = _AGG_ARGS[:7] + [ctypes.c_void_p, ctypes.c_void_p] + \
    _AGG_ARGS[7:]
# scores: (dtype, device, emb, emb_stride, target_rows, out, B, U, H, eps,
#          tb, tu, unit, hs, vec, stream)
_SCORE_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# rows: (dtype, device, table, table_stride, idx, out, rows, D, unit,
#        stream)
_ROWS_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]
# scatter: (device, g, idx, scratch, scratch_ints, out, J, D, M, unit,
#           group, vec, k_long, long_blocks, long_smem, stream)
_SCATTER_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p]
# scratch: (J, M, k_long) -> int32 count; add latency: (device, in, out, n,
# stream)
_SCRATCH_ARGS = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
_LATENCY_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p]
# pretransform: (device, h, h_stride, pieces, z, N, K, P, bn, unit, stream);
# with the epilogue, the bias before the stream; its pack: (device, w,
# w_stride, out, P, K, bn, stream)
_PRETRANSFORM_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
_PRETRANSFORM_BIAS_ARGS = _PRETRANSFORM_ARGS[:-1] + [ctypes.c_void_p,
                                                     ctypes.c_void_p]
_PACK_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ERROR_STRING = ([ctypes.c_int], ctypes.c_char_p)
_SIGNATURES = {
    "aggregate": {
        "gs_gather_mean": (_AGG_ARGS, ctypes.c_int),
        "gs_gather_max": (_AGG_ARGS, ctypes.c_int),
        "gs_gather_max_bwd": (_MAX_BWD_ARGS, ctypes.c_int),
        "gs_error_string": _ERROR_STRING,
    },
    "sddmm": {
        "gs_pair_scores": (_SCORE_ARGS, ctypes.c_int),
        "gs_error_string": _ERROR_STRING,
    },
    "gather": {
        "gs_gather_rows": (_ROWS_ARGS, ctypes.c_int),
        "gs_error_string": _ERROR_STRING,
    },
    "scatter": {
        "gs_scatter_rows": (_SCATTER_ARGS, ctypes.c_int),
        "gs_scatter_scratch": (_SCRATCH_ARGS, ctypes.c_int64),
        "gs_scatter_add_latency": (_LATENCY_ARGS, ctypes.c_int),
        "gs_error_string": _ERROR_STRING,
    },
    "pretransform": {
        "gs_pretransform": (_PRETRANSFORM_ARGS, ctypes.c_int),
        "gs_pretransform_bias_relu": (_PRETRANSFORM_BIAS_ARGS, ctypes.c_int),
        "gs_pretransform_pack": (_PACK_ARGS, ctypes.c_int),
        "gs_error_string": _ERROR_STRING,
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgs_{name}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source that has no current build, one ``nvcc`` each,
    all running at once; return {name: .so path}."""
    paths = {name: library_path(name) for name in SOURCES}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in missing:
        out = paths[name]
        # compile to a private name, then rename: concurrent builds never
        # see a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((out, tmp, cmd, proc))
    failed = []
    for out, tmp, cmd, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc rc={proc.returncode}: {' '.join(cmd)}\n"
                          f"{report}")
            continue
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (a key of :data:`SOURCES`).
    The first call builds every source, so they compile in parallel; once
    a library is loaded, a call returns it without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if not _libs:
            for lib_name, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn_name, (argtypes, restype) in _SIGNATURES[
                        lib_name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _libs[lib_name] = lib
        return _libs[name]
