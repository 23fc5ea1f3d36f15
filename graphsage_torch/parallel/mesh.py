"""The ``data`` x ``model`` mesh over ranks, and the tensor-parallel
placement of the params.

Port of ``graphsage_tpu/parallel/mesh.py``.  The JAX package builds a
``Mesh`` of devices and lets GSPMD place arrays by ``NamedSharding``; the
port runs one process a rank (``parallel/multihost.py``), so a mesh is
this rank's coordinates and the two process groups it reduces over:

- ``data``: the batch axis.  The ``n_data`` ranks that hold the same model
  slice average their gradients (``data_group``);
- ``model``: the hidden axis of the SageLayer weights and the classifier.
  The ``n_model`` ranks of one data shard each hold a slice of every
  sharded weight and join their activations (``model_group``).

Ranks lie on the grid as JAX lays devices out by ``reshape(n_data,
n_model)``: rank = d·n_model + m.

:func:`shard_params` is JAX's ``shard_params`` (``mesh.py:44-61``): each
SageLayer weight [out, in] is split by rows over ``model`` (a model rank
computes a column slice of the layer's output), the classifier weight
[C, H] by columns (its input dim), and every other leaf is replicated.
JAX's ``batch_sharding`` is :func:`batch_rows`, this data rank's rows of
the global batch; its ``replicated`` needs no code (every rank holds the
whole array).  ``train.dense.make_dense_sup_step(mesh=...)`` runs the
tensor-parallel step over this layout.  Nothing pads: a hidden size or a
batch that does not divide raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from graphsage_torch.parallel.comm import all_gather_no_grad
from graphsage_torch.parallel.multihost import _timeout


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (n_data, n_model) grid and its groups:
    ``data_group`` holds the ranks of its model column (the same model
    slice, other batch rows), ``model_group`` those of its data row (the
    same batch rows, the other model slices)."""
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over the ranks of the default group, whose size must be
    n_data·n_model (``n_data`` defaults to size // n_model).  Every rank
    must call it, in the same order among its other group-forming calls:
    it forms every subgroup on every rank, as
    ``torch.distributed.new_group`` requires."""
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model {n_model} does not divide the "
                         f"{world} ranks")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data} x {n_model}) mesh needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    grid = [list(range(d * n_model, (d + 1) * n_model))
            for d in range(n_data)]
    timeout = _timeout(None)
    data_groups = [dist.new_group([row[m] for row in grid], timeout=timeout)
                   for m in range(n_model)]
    model_groups = [dist.new_group(row, timeout=timeout) for row in grid]
    data_rank, model_rank = divmod(dist.get_rank(), n_model)
    return Mesh(n_data, n_model, data_rank, model_rank,
                data_groups[model_rank], model_groups[data_rank])


def sharded_dim(path: tuple, leaf: torch.Tensor) -> int | None:
    """The dim of ``leaf`` split over ``model`` (JAX's rule, by the names
    on its path): 0 for a 2-D leaf under "layers" (a SageLayer weight), 1
    for a 2-D leaf under "clf" (the classifier weight); None (replicated)
    for every other leaf."""
    if leaf.ndim == 2:
        if "layers" in path:
            return 0
        if "clf" in path:
            return 1
    return None


def map_with_paths(fn, tree, path: tuple = ()):
    """The pytree of ``fn(path, leaf)`` over a param pytree; a path is the
    dict keys and list positions from the root, after ``path``."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slice of every leaf of ``params`` (the whole pytree, as
    ``{"sage": ..., "clf": ...}``): rows m·H/n : (m+1)·H/n of each
    SageLayer weight, the same columns of the classifier weight, every
    other leaf whole.  Copies, each a leaf that requires grad as its
    source does."""
    def place(path, leaf):
        dim = sharded_dim(path, leaf)
        if dim is not None:
            size = leaf.shape[dim]
            if size % mesh.n_model:
                raise ValueError(
                    f"{'/'.join(map(str, path))} has {size} along its "
                    f"sharded dim, which {mesh.n_model} model ranks do "
                    f"not divide")
            part = size // mesh.n_model
            leaf = leaf.narrow(dim, mesh.model_rank * part, part)
        return (leaf.detach().clone(memory_format=torch.contiguous_format)
                .requires_grad_(leaf.requires_grad))

    return map_with_paths(place, params)


def gather_params(params: dict, mesh: Mesh) -> dict:
    """The whole params back from every model rank's slices (the inverse
    of :func:`shard_params`), on every rank, without a gradient: for
    checks and for export."""
    def join(path, leaf):
        dim = sharded_dim(path, leaf)
        if dim == 0:
            return all_gather_no_grad(leaf, mesh.model_group)
        if dim == 1:
            return all_gather_no_grad(leaf.detach().t(),
                                      mesh.model_group).t().contiguous()
        return leaf.detach().clone()

    return map_with_paths(join, params)


def batch_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This data rank's contiguous block of the leading axis of ``x``: its
    rows of the global batch, or of a per-occurrence frontier, where the
    subtree of batch row b is contiguous at every depth
    (``sampler/device.py``).  A view."""
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"{n} rows do not divide over {mesh.n_data} data "
                         f"ranks")
    part = n // mesh.n_data
    return x[mesh.data_rank * part:(mesh.data_rank + 1) * part]
