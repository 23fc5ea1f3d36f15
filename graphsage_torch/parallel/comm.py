"""The collectives of the distributed pipelines, on ``torch.distributed``.

The JAX package runs one process that drives every device through
``shard_map``; the port runs one process a rank (``parallel/multihost.py``
forms the group), and each rank runs what the JAX package calls the
per-device body.  The collectives inside those bodies map so:

- ``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=False)``
  (``graphsage_tpu/parallel/halo.py:158,162``): :func:`all_to_all_rows`,
  ``all_to_all_single`` over the leading axis; its backward is the same
  exchange of the gradient (an all_to_all is its own transpose);
- ``lax.all_gather(x, axis=0, tiled=True)``
  (``graphsage_tpu/train/cached_dist.py:194``, ``infer.py:269-280``):
  :func:`all_gather_rows`, ``all_gather_into_tensor``; its backward is the
  SUM reduce-scatter, JAX's ``psum_scatter`` transpose;
- ``lax.pmean`` of the loss inside the differentiated function
  (``train/distributed.py:229``, ``cached_dist.py:281,371``): a local
  backward, then :func:`mean_over_ranks` of the float32 gradients (SUM
  all-reduce, divided by the world size) before the clip.  Differentiating
  the local loss alone gives rank r d(loss_r); the mean of those is the
  gradient of the mean loss.  Summing them without the division would give
  P times the update (the trap of ``distributed.py:222-228``).
- ``lax.axis_index``: :func:`rank_world`'s rank.

The tensor-parallel ``model`` axis (``parallel/mesh.py``) needs two more,
which GSPMD inserts for the JAX package and the port writes out:

- :func:`all_gather_cols`: each model rank's [u, H/n] column slice of a
  layer's output joined into [u, H] before the next layer; its backward is
  the SUM reduce-scatter of the column slices (each rank's slice of the
  next layer's input gradient summed over the ranks that read it);
- :func:`sum_partials`: the classifier's partial logits summed over the
  model group (SUM all-reduce); its backward is the identity, since every
  rank's partial enters the sum once;
- :func:`sum_over_ranks`: the gradient shares of the replicated LSTM
  cells summed over the model group (``train.optim``), where each rank's
  slice of a layer contributes its own share.

The two differentiable collectives are ``torch.autograd.Function``s with
their backward written out (``torch.distributed.nn.functional``'s backward
has changed between torch versions).  Every rank must call the same
collectives in the same order: the port's ranks run one program on
replicated host state, as the JAX package's ``shard_map`` body does.  At
world size 1 the same calls go to the backend (NCCL on the card): there is
no shortcut.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def rank_world(group=None) -> tuple[int, int]:
    """(this process's rank, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [P, ...] -> [P, ...]: x[q] goes to rank q, and row q of the result
    is what rank q sent here.  Differentiable in floating-point x."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"leading axis {x.shape[0]} is not the world size "
                         f"{dist.get_world_size(group)}")
    if not x.is_floating_point():
        return _all_to_all(x, group)
    return _AllToAllRows.apply(x, group)


def _reduce_scatter_sum(g: torch.Tensor, group) -> torch.Tensor:
    g = g.contiguous()
    world = dist.get_world_size(group)
    out = torch.empty((g.shape[0] // world,) + tuple(g.shape[1:]),
                      dtype=g.dtype, device=g.device)
    with warnings.catch_warnings():
        # newer torch renames it reduce_scatter_single; older has only this
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # newer torch renames it all_gather_single; older has only this
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_sum(g, ctx.group), None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [R, ...] on every rank -> [P·R, ...], rank q's rows at [q·R,
    (q+1)·R).  The gradient of rank r's x is the SUM over ranks of the
    result's gradient at rank r's rows."""
    return _AllGatherRows.apply(x, group)


class _AllGatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world = dist.get_world_size(group)
        u, c = x.shape
        stacked = _all_gather(x, group).reshape(world, u, c)
        return stacked.transpose(0, 1).reshape(u, world * c)

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        u, h = g.shape
        slices = g.reshape(u, world, h // world).transpose(0, 1)
        return _reduce_scatter_sum(slices.reshape(world * u, h // world),
                                   ctx.group), None


def all_gather_cols(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [u, c] on every rank -> [u, P·c], rank q's columns at [q·c,
    (q+1)·c).  The gradient of rank r's x is the SUM over ranks of the
    result's gradient at rank r's columns."""
    return _AllGatherCols.apply(x, group)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise SUM over ranks of x (each rank's partial product),
    the same on every rank; each rank's x gets the result's gradient."""
    return _SumPartials.apply(x, group)


def sum_over_ranks(tensors: list[torch.Tensor],
                   group=None) -> list[torch.Tensor]:
    """The elementwise SUM over ranks of each tensor (float32, one
    all-reduce of their concatenation); the results are views of one
    buffer."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def mean_over_ranks(tensors: list[torch.Tensor],
                    group=None) -> list[torch.Tensor]:
    """The elementwise mean over ranks of each tensor (float32, one SUM
    all-reduce of their concatenation, divided by the world size): the
    gradients and the loss of one step in one collective."""
    world = dist.get_world_size(group)
    return [t.div_(world) for t in sum_over_ranks(tensors, group)]


def all_gather_no_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x [R, ...] stacked on the leading axis (no gradient),
    for results every rank needs whole, such as evaluation embeddings."""
    return _all_gather(x.detach(), group)
