"""Row gather ``out[j] = table[idx[j]]``: plain PyTorch and the CUDA kernel.

Port of the row gather that ``tools/pallas_microbench.py:87``
(``gather_kernel``) measures on the TPU, and that the JAX package's
leaf-cached pipeline runs as ``jnp.take(table, ids, axis=0)`` for every
layer-1 gather (``graphsage_tpu/train/cached.py:198-211``).

- ``gather_rows_plain``: ``index_select``, on any device; the CPU path and
  the reference the kernel is held against on the card.
- ``gather_rows_kernel``: the hand-written CUDA kernel
  (``graphsage_torch/csrc/gather.cu``), a CUDA tensor only.
- ``GatherRows``: the gather with the VJP of ``jnp.take(table, ids,
  axis=0)``, the output gradient added into a zero [M, D] by
  ``ops.scatter.scatter_rows`` (JAX's order of the bfloat16 adds).
  Its forward is the kernel on a CUDA tensor and the plain version on a
  CPU tensor.  Only the full-table branch of the cached forward needs the
  backward (its table carries the gradient of W1); the per-occurrence
  branch gathers from constant tables.
- ``gather_rows``: goes through ``GatherRows``.  On a CUDA tensor it
  launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import build
from graphsage_torch.ops.aggregate import (_DTYPE_CODES, _INT_MAX, LAUNCHES,
                                          widest_unit)
from graphsage_torch.ops.scatter import scatter_rows


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [M, D] x idx [J] int -> [J, D] (plain)."""
    return table.index_select(0, idx.long())


def _check_kernel_args(table: torch.Tensor, idx: torch.Tensor) -> None:
    """What the kernel takes: table [M, D] float32/bfloat16 with unit column
    stride (any row stride), idx [J] int32 contiguous, both on one CUDA
    device."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [M, D] and idx [J]; got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"table must be float32 or bfloat16, not "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if table.shape[1] > 1 and table.stride(1) != 1:
        raise ValueError(f"table needs unit column stride, has strides "
                         f"{table.stride()}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    if max(idx.shape[0], *table.shape) > _INT_MAX:
        raise ValueError("J, M and D must each fit in 32 bits")
    if not (table.is_cuda and idx.device == table.device):
        raise ValueError(f"table and idx must lie on one CUDA device; got "
                         f"{table.device}, {idx.device}")


def gather_rows_kernel(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the ``gather_rows`` CUDA kernel: [M, D] x [J] -> [J, D] in the
    table's dtype, equal to ``index_select`` bit for bit.  An empty idx
    launches nothing.  Forward only; ``GatherRows`` gives it a gradient."""
    _check_kernel_args(table, idx)
    j = idx.shape[0]
    d = table.shape[1]
    out = torch.empty((j, d), dtype=table.dtype, device=table.device)
    if j == 0 or d == 0:
        return out
    lib = build.load_library("gather")
    elt = table.element_size()
    unit = widest_unit(elt, table.data_ptr() % 16, table.stride(0) * elt,
                       d * elt, out.data_ptr() % 16)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.gs_gather_rows(_DTYPE_CODES[table.dtype], table.device.index,
                            table.data_ptr(), table.stride(0), idx.data_ptr(),
                            out.data_ptr(), j, d, unit, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")
    LAUNCHES["gather_rows"] += 1
    return out


class GatherRows(torch.autograd.Function):
    """The row gather with the ``scatter_rows`` backward; the gradient
    flows to ``table`` only."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        if not table.is_cuda:
            return gather_rows_plain(table, idx)
        return gather_rows_kernel(table, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.num_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``, differentiable in ``table``.  CPU
    tensors take :func:`gather_rows_plain`; CUDA tensors launch the
    ``gather_rows`` kernel (see :func:`_check_kernel_args` for what it
    takes)."""
    return GatherRows.apply(table, idx)
