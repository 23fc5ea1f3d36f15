"""ctypes bindings of the native host graph engine (csrc/gs_native.cpp).

The port's own binding of the entry points the JAX package binds
(``graphsage_tpu/native/engine.py``), loaded from the port's build
(``graphsage_torch.native.build``).  numpy arrays pass straight through as
int32 / float32 / uint8 pointers.  The library is built at first use; a
build or load that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from graphsage_torch.native import build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.c_int32
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "gs_build_compact_batch": [
        _I32P, _I32P, _I32, _I32P, _I32, _I32, _I32, _I32, _U64, _I32P,
        _I32P, _I32P, _I32P, _F32P, _I32P],
    "gs_bfs_closure": [_I32P, _I32P, _I32, _I32, _I32, _U8P, _I32P],
    "gs_sample_fanout": [_I32P, _I32P, _I32, _I32P, _I32, _I32, _U64, _I32P,
                         _I32P],
    "gs_far_lists": [_I32P, _I32P, _I32, _I32P, _I32, _I32, _I32P, _I32,
                     _I32, _I32P, _I32P],
    "gs_uniform_negatives": [_I32P, _I32P, _I32, _I32P, _I32, _I32P, _I32,
                             _I32, _U64, _I32P, _U8P],
}


def load() -> ctypes.CDLL:
    """Build (once per source version) and load the engine."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.int32)


def build_compact_batch_native(indptr: np.ndarray, indices: np.ndarray,
                               num_nodes: int, batch: np.ndarray,
                               num_layers: int, fanout: int, gcn: bool,
                               seed: int, u_caps: np.ndarray):
    """(union_sizes, x0_ids [cap_L], [(idx, mask, self_idx)] bottom-up at
    the cap sizes).  Raises RuntimeError on cap overflow."""
    lib = load()
    slots = fanout + 1
    batch, indptr, indices, u_caps = map(_i32, (batch, indptr, indices,
                                                u_caps))
    union_sizes = np.zeros(num_layers + 1, dtype=np.int32)
    x0_ids = np.zeros(int(u_caps[num_layers]), dtype=np.int32)
    # bottom-up layer j has rows u_caps[num_layers-1-j]
    row_caps = [int(u_caps[num_layers - 1 - j]) for j in range(num_layers)]
    total_rows = sum(row_caps)
    idx_buf = np.zeros(total_rows * slots, dtype=np.int32)
    mask_buf = np.zeros(total_rows * slots, dtype=np.float32)
    self_buf = np.zeros(total_rows, dtype=np.int32)

    rc = lib.gs_build_compact_batch(
        _p(indptr, ctypes.c_int32), _p(indices, ctypes.c_int32),
        int(num_nodes), _p(batch, ctypes.c_int32), len(batch),
        int(num_layers), int(fanout), 1 if gcn else 0, int(seed) % 2**64,
        _p(u_caps, ctypes.c_int32), _p(union_sizes, ctypes.c_int32),
        _p(x0_ids, ctypes.c_int32), _p(idx_buf, ctypes.c_int32),
        _p(mask_buf, ctypes.c_float), _p(self_buf, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"gs_build_compact_batch cap overflow level "
                           f"{-rc - 1}: sizes={union_sizes} caps={u_caps}")

    layers = []
    io = so = 0
    for rows in row_caps:
        layers.append((idx_buf[io:io + rows * slots].reshape(rows, slots),
                       mask_buf[io:io + rows * slots].reshape(rows, slots),
                       self_buf[so:so + rows]))
        io += rows * slots
        so += rows
    return union_sizes, x0_ids, layers


def bfs_closure_native(indptr: np.ndarray, indices: np.ndarray,
                       num_nodes: int, root: int,
                       max_hops: int) -> np.ndarray:
    """Bit-packed <= max_hops closure of ``root`` (packbits layout)."""
    lib = load()
    indptr, indices = _i32(indptr), _i32(indices)
    bits = np.zeros((num_nodes + 7) // 8, dtype=np.uint8)
    work = np.zeros(num_nodes, dtype=np.int32)
    lib.gs_bfs_closure(_p(indptr, ctypes.c_int32),
                       _p(indices, ctypes.c_int32), int(num_nodes),
                       int(root), int(max_hops), _p(bits, ctypes.c_uint8),
                       _p(work, ctypes.c_int32))
    return bits


def far_lists_native(indptr: np.ndarray, indices: np.ndarray,
                     num_nodes: int, roots: np.ndarray, max_hops: int,
                     train: np.ndarray, n_threads: int | None = None,
                     chunk_bytes: int = 64 << 20) -> list[np.ndarray]:
    """Exact-negative far lists: for each root, the train nodes outside its
    <= max_hops BFS closure (reference src/models.py:153-167), on a C++
    thread pool; one fresh int32 array per root.  Roots are chunked so the
    [chunk, n_train] scratch stays under ``chunk_bytes``."""
    lib = load()
    if n_threads is None:
        n_threads = max(1, os.cpu_count() or 1)
    indptr, indices, roots, train = map(_i32, (indptr, indices, roots,
                                               train))
    n_train = len(train)
    chunk = max(1, int(chunk_bytes // max(1, n_train * 4)))
    out: list[np.ndarray] = []
    for lo in range(0, len(roots), chunk):
        part = roots[lo:lo + chunk]
        far_buf = np.empty((len(part), n_train), dtype=np.int32)
        counts = np.zeros(len(part), dtype=np.int32)
        lib.gs_far_lists(
            _p(indptr, ctypes.c_int32), _p(indices, ctypes.c_int32),
            int(num_nodes), _p(part, ctypes.c_int32), len(part),
            int(max_hops), _p(train, ctypes.c_int32), n_train,
            int(n_threads),
            _p(far_buf, ctypes.c_int32), _p(counts, ctypes.c_int32))
        out.extend(far_buf[i, :counts[i]].copy() for i in range(len(part)))
    return out


def uniform_negatives_native(indptr: np.ndarray, indices: np.ndarray,
                             num_nodes: int, train: np.ndarray,
                             nodes: np.ndarray, num_neg: int, seed: int):
    """Uniform negatives (train minus the node and its 1-hop neighbours,
    without replacement): (neg [n, num_neg] int32, valid [n, num_neg]
    bool)."""
    lib = load()
    indptr, indices, train, nodes = map(_i32, (indptr, indices, train,
                                               nodes))
    out = np.zeros((len(nodes), num_neg), dtype=np.int32)
    valid = np.zeros((len(nodes), num_neg), dtype=np.uint8)
    lib.gs_uniform_negatives(
        _p(indptr, ctypes.c_int32), _p(indices, ctypes.c_int32),
        int(num_nodes), _p(train, ctypes.c_int32), len(train),
        _p(nodes, ctypes.c_int32), len(nodes), int(num_neg),
        int(seed) % 2**64, _p(out, ctypes.c_int32),
        _p(valid, ctypes.c_uint8))
    return out, valid.astype(bool)


def sample_fanout_native(indptr: np.ndarray, indices: np.ndarray,
                         num_nodes: int, nodes: np.ndarray, fanout: int,
                         seed: int):
    """Uniform fanout samples: (samples [n, fanout], counts [n])."""
    lib = load()
    indptr, indices, nodes = map(_i32, (indptr, indices, nodes))
    out = np.zeros((len(nodes), fanout), dtype=np.int32)
    counts = np.zeros(len(nodes), dtype=np.int32)
    lib.gs_sample_fanout(_p(indptr, ctypes.c_int32),
                         _p(indices, ctypes.c_int32), int(num_nodes),
                         _p(nodes, ctypes.c_int32), len(nodes), int(fanout),
                         int(seed) % 2**64, _p(out, ctypes.c_int32),
                         _p(counts, ctypes.c_int32))
    return out, counts
