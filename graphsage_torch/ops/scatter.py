"""Scatter-add of row gradients, ``out[r] = sum of g[j] over idx[j] == r``:
the backward of every row gather that carries a gradient.

The JAX package differentiates its gathers (``jnp.take``, and the Pallas
aggregates' ``_pallas_mean_bwd`` and ``_pallas_max_bwd``,
``graphsage_tpu/ops/pallas_aggregate.py:147-184``) into the XLA scatter
``jnp.zeros_like(embed).at[idx].add(contrib)`` in the embed dtype.  XLA
on the CPU adds the contributions one at a time in index order, each add
rounded to that dtype (``tests/test_torch_bf16.py`` holds the port against
JAX's VJPs bit for bit there; the TPU's order is not measured).  In
bfloat16 the order decides the result: a running sum stops growing once it
is about 256 times a term, so a hub row of the power-law graph ends far
from its exact sum, at a place that depends on the order.  So the
bfloat16 scatter keeps JAX's order on both devices:

- ``scatter_rows_plain``: plain PyTorch on any device, the CPU path and the
  reference the kernel is held against: the contributions grouped by their
  rank within their row, one elementwise bfloat16 add a rank.
- ``scatter_rows_kernel``: the hand-written CUDA kernel
  (``graphsage_torch/csrc/scatter.cu``), bfloat16 CUDA tensors only; equal
  to the plain version bit for bit.  One call is one scratch tensor, one
  output and one C call: a memset and three launches, a counting sort by
  row of its own (count the nonzero contributions of each row, place each
  at its row's segment in runs of index order, sort each segment where it
  is summed: in registers for a row of at most 256, by its runs for a
  longer one) and each row's chain of adds, in the launch plan of
  :func:`scatter_plan`.
- ``scatter_rows``: float32 (any dtype but bfloat16) takes ``index_add_``
  on both devices (atomics on the card: the order moves only the last bits
  there, and the float32 paths keep what earlier measurements timed);
  bfloat16 takes the plain version on a CPU tensor and launches the kernel
  on a CUDA tensor.
- ``take_rows``: the row gather ``table[idx]`` (``index_select``, not a
  kernel: ``jnp.take`` is an XLA gather in the JAX package) with the
  ``scatter_rows`` backward: the self-row gathers of the layers and the
  pair gathers of the losses.

Contributions that are +-0 in every element are skipped: added to a sum
that started at +0 they leave it unchanged, and the sampler's padding slots
send many such rows to one id.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from graphsage_torch.ops import build
from graphsage_torch.ops.aggregate import _INT_MAX, LAUNCHES, widest_unit

# What gs_scatter_rows (csrc/scatter.cu) takes: a long row is one of more
# than k_long <= MAX_K_LONG contributions; a long block's ring has 2 to
# MAX_SLOTS slots of SLOT_ROWS contributions of 32 min(vec, 2) columns in
# at most MAX_LONG_SMEM bytes, which also hold its sort's window (a start
# and a length a place block); the scratch has HEADER int32 before the
# rows' counts.
MAX_K_LONG, SLOT_ROWS, MAX_SLOTS = 256, 64, 64
MAX_LONG_SMEM, HEADER = 200 * 1024, 4
# contributions a place block takes: a long row's sort orders its runs, one
# a place block, in windows of long_smem / 8 place blocks
PLACE_BLOCK = 256
# the plan's choices: rows of more than K_LONG contributions take a block
# (K_LONG <= MAX_K_LONG / 2 at 8 columns a lane);
# LONG_BLOCKS_MAX of them (two a streaming multiprocessor of the H100) take
# the long list; a long block's ring and sort window, LONG_SMEM bytes,
# leave room for four blocks a multiprocessor (the short rows' warps)
K_LONG, LONG_BLOCKS_MAX, LONG_SMEM = 64, 264, 48 * 1024


class ScatterPlan(NamedTuple):
    unit: int         # count pass: bytes a lane loads (2, 4, 8 or 16)
    group: int        # count pass: lanes a contribution row
    vec: int          # sum pass: bfloat16 columns a lane (1, 2, 4 or 8)
    k_long: int       # a row of more contributions takes a block
    long_blocks: int  # blocks that take the long list
    long_smem: int    # a long block's ring and sort window, bytes
    scratch: int      # int32 of scratch


def scratch_ints(j: int, m: int, k_long: int) -> int:
    """The int32 scratch of a call (``gs_scatter_scratch``): the header,
    each row's count, cursor and segment, the long list, and each
    contribution's key, position, run mark and place in a second order."""
    return HEADER + 3 * m + j // (k_long + 1) + 4 * j


@functools.lru_cache(maxsize=256)
def scatter_plan(j: int, d: int, m: int, g_mod16: int,
                 out_mod16: int) -> ScatterPlan:
    """The launch plan of ``gs_scatter_rows`` for g [j, d] at ``g_mod16``
    (its address mod 16) into [m, d] at ``out_mod16``.

    The count pass loads the widest unit that divides g's address and its
    row (16 bytes at width 128) with a power-of-two group of lanes a row
    (16 at width 128, two rows a warp).  The sum pass gives a short row 16
    lanes of 8 columns (four bf16x2 chains, two rows a warp) at widths 72
    to 128 where 16-byte loads fit, else a warp whose lanes take the most
    columns, up to 4, that divide the width and both addresses without
    leaving lanes of a 32-lane chunk idle."""
    unit = widest_unit(2, g_mod16, 2 * d)
    group = min(32, 1 << max(0, (2 * d // unit - 1).bit_length()))
    cols = widest_unit(2, g_mod16, 2 * d, out_mod16) // 2
    if cols == 8 and 64 < d <= 128:   # 16 lanes a row, two rows a warp
        vec = 8
    else:
        vec = min(4, cols)
        while vec > 1 and 32 * vec > d:
            vec //= 2
    long_blocks = max(1, min(j // (K_LONG + 1), LONG_BLOCKS_MAX))
    return ScatterPlan(unit, group, vec, K_LONG, long_blocks, LONG_SMEM,
                       scratch_ints(j, m, K_LONG))


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """g [J, D] added into a zero [num_rows, D] of g's dtype at rows idx
    [J], one contribution at a time in increasing j (plain)."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype,
                      device=g.device)
    keep = torch.nonzero((g != 0).any(dim=1)).reshape(-1)
    if keep.numel() == 0:
        return out
    rows = idx.reshape(-1).long()[keep]
    order = torch.argsort(rows, stable=True)
    sorted_rows = rows[order]
    counts = torch.bincount(sorted_rows, minlength=num_rows)
    first = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(order.numel(), device=g.device)
            - first[sorted_rows])
    by_rank = order[torch.argsort(rank, stable=True)]
    rows, terms = rows[by_rank], g[keep[by_rank]]
    lo = 0
    # rank r holds at most one contribution a row: one elementwise add each
    for hi in torch.cumsum(torch.bincount(rank), 0).tolist():
        r = rows[lo:hi]
        out.index_put_((r,), out.index_select(0, r) + terms[lo:hi])
        lo = hi
    return out


def _check_kernel_args(g: torch.Tensor, idx: torch.Tensor,
                       num_rows: int) -> None:
    """What the kernel takes: g [J, D] bfloat16 contiguous, idx [J] int32
    contiguous with values in [0, num_rows), both on one CUDA device."""
    if g.dim() != 2 or idx.dim() != 1 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"expected g [J, D] and idx [J]; got "
                         f"{tuple(g.shape)}, {tuple(idx.shape)}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16, not {g.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("g and idx must be contiguous")
    if max(*g.shape, num_rows) >= _INT_MAX:
        raise ValueError("J, D and the row count must fit in 31 bits")
    if not (g.is_cuda and idx.device == g.device):
        raise ValueError(f"g and idx must lie on one CUDA device; got "
                         f"{g.device}, {idx.device}")


def scatter_rows_kernel(g: torch.Tensor, idx: torch.Tensor, num_rows: int,
                        plan: ScatterPlan | None = None) -> torch.Tensor:
    """Launch the ``scatter_rows`` CUDA kernel: g [J, D] bfloat16 added into
    a zero [num_rows, D] at rows idx [J] in increasing j, equal to
    ``scatter_rows_plain`` bit for bit.  ``plan`` replaces
    :func:`scatter_plan`'s (for tests of other plans)."""
    _check_kernel_args(g, idx, num_rows)
    j, d = g.shape
    out = torch.empty((num_rows, d), dtype=g.dtype, device=g.device)
    if d == 0:
        return out
    if plan is None:
        plan = scatter_plan(j, d, num_rows, g.data_ptr() % 16,
                            out.data_ptr() % 16)
    lib = build.load_library("scatter")
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=g.device)
    rc = lib.gs_scatter_rows(
        g.device.index, g.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
        plan.scratch, out.data_ptr(), j, d, num_rows, plan.unit, plan.group,
        plan.vec, plan.k_long, plan.long_blocks, plan.long_smem,
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_rows launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")
    LAUNCHES["scatter_rows"] += 1
    return out


def scatter_rows(g: torch.Tensor, idx: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """d(table) of the gather ``table[idx]`` with output gradient g [J, D]:
    a [num_rows, D] tensor of g's dtype (see the module docstring for
    which version runs)."""
    idx = idx.reshape(-1)
    if g.dtype != torch.bfloat16:
        out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        return out.index_add_(0, idx.long(), g)
    if not g.is_cuda:
        return scatter_rows_plain(g, idx, num_rows)
    return scatter_rows_kernel(g.contiguous(), idx.int().contiguous(),
                               num_rows)


class TakeRows(torch.autograd.Function):
    """``table[idx]`` with the ``scatter_rows`` backward; the gradient
    flows to ``table`` only."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.num_rows), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [M, D] at ``idx`` (any shape) -> [*idx.shape, D],
    differentiable in ``table``."""
    out = TakeRows.apply(table, idx.reshape(-1))
    return out.reshape(*idx.shape, table.shape[1])
