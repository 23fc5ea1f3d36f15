"""Sharded leaf-cached training: the cached pipeline over ranks.

Port of ``graphsage_tpu/train/cached_dist.py``.  The node-table ROWS are
sharded over the P ranks of a ``torch.distributed`` group, and each rank
runs the JAX package's per-device program on its batch shard:

- refresh (:func:`local_refresh`): the rank draws and aggregates the leaf
  cache of its OWN N/P-row range (one ``gather_mean`` / ``gather_max``
  launch over the replicated feature table; no collective);
- layer 1 (:func:`sharded_forward`): ``h1_local = relu(W1·[X_local ‖
  C_local])`` over the rank's rows, then ``comm.all_gather_rows`` assembles
  the [N, H] activation table (its backward is the SUM reduce-scatter that
  lands each rank its own rows' d(h1));
- layers 2..L and the loss: rank-local over fresh device frontiers, the
  layer-1 rows taken from the table by the ``gather_rows`` kernel (its
  backward ``scatter_rows``, the kernel in bfloat16);
- update (``train.optim.apply_gradients_mean``): the local backward, the
  mean over ranks of the float32 gradients (JAX's ``pmean`` inside the
  loss), clip, SGD on the replicated params.

The tables (features, neighbours, degrees) stay replicated, padded to a
multiple of P rows (:func:`pad_node_tables`: padded rows have degree 0, so
they are never sampled and their cache and h1 rows are zero).

The epochs are ``train.cached.cached_epoch_reuse`` over a
:class:`CachedDistStep`, given the rank's (x_local, cache_local,
cnt_local) in place of the tables and its [T, b_loc] row of the epoch
stack.  The per-rank device samples come from a hop sampler whose
``torch.Generator`` is seeded from (seed, rank), as JAX folds
``axis_index`` into its keys (``cached_dist.py:166,294,383``).

The host stacks (:func:`build_epoch_stack`, :func:`build_unsup_epoch_stack`)
are numpy copies of the JAX package's, bit-identical: every rank builds the
global [T, P, ...] stack from the shared RandomState and takes its row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from graphsage_torch.models.graphsage import GraphSageConfig
from graphsage_torch.models.layers import sage_layer_apply
from graphsage_torch.ops.aggregate import max_aggregate, mean_aggregate
from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.parallel import comm
from graphsage_torch.sampler.compact import _bucket
from graphsage_torch.train.cached import CachedStep, _gcn_mix, _upper_layers
from graphsage_torch.train.cached_trainer import PAIR_FIELDS
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.optim import apply_gradients_mean

# --------------------------------------------------------------------- host
def pad_node_tables(feats: np.ndarray, neighbors: np.ndarray,
                    degrees: np.ndarray, n_dev: int):
    """Pad the [N, ...] node tables to a multiple of n_dev rows so they
    shard evenly.  Padded rows have degree 0 (never sampled: the adjacency
    only points at real nodes), and zero cache and h1 rows."""
    n = feats.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    if n_pad == n:
        return feats, neighbors, degrees
    extra = n_pad - n
    feats = np.concatenate(
        [feats, np.zeros((extra, feats.shape[1]), feats.dtype)])
    neighbors = np.concatenate(
        [neighbors, np.zeros((extra, neighbors.shape[1]), neighbors.dtype)])
    degrees = np.concatenate([degrees, np.zeros(extra, degrees.dtype)])
    return feats, neighbors, degrees


def build_epoch_stack(train_nodes: np.ndarray, labels: np.ndarray,
                      n_dev: int, b_sz: int, rng: np.random.RandomState):
    """Shuffle and pack one epoch into sharded step arrays.

    Returns (batches [T, n_dev, b_loc] int32, labels [T, n_dev, b_loc]
    int32, row_masks [T, n_dev, b_loc] float32), b_loc = b_sz // n_dev;
    the wrap-padded tail rows carry row_mask 0."""
    assert b_sz % n_dev == 0, (b_sz, n_dev)
    order = rng.permutation(train_nodes).astype(np.int32)
    t = -(-len(order) // b_sz)
    padded = np.resize(order, t * b_sz)
    masks = np.ones(t * b_sz, np.float32)
    masks[len(order):] = 0.0
    batches = padded.reshape(t, n_dev, b_sz // n_dev)
    row_masks = masks.reshape(t, n_dev, b_sz // n_dev)
    labs = labels[batches].astype(np.int32)
    return batches, labs, row_masks


def build_unsup_epoch_stack(pair_sampler, train_nodes: np.ndarray,
                            labels: np.ndarray, n_dev: int, b_sz: int,
                            num_neg: int, rng: np.random.RandomState):
    """Shuffle and pack one unsup/plus_unsup epoch: per step and rank,
    extend the b_loc-node chunk with walk-positive / negative pair
    endpoints (reference src/models.py:135-148) and pad the extended
    batches to one common width.

    Returns (batches [T, n_dev, U] int32, labels [T, n_dev, U] int32,
    row_masks [T, n_dev, U] float32, pair_stack {field: [T, n_dev, ...]}),
    numpy.  The tail chunk smaller than one grid is dropped.  Pair index
    fields point at rows of each rank's own extended batch."""
    assert b_sz % n_dev == 0, (b_sz, n_dev)
    b_loc = b_sz // n_dev
    order = rng.permutation(train_nodes).astype(np.int64)
    t_steps = max(1, len(order) // b_sz)
    pbs = [[pair_sampler.sample_batch(
        order[t * b_sz + d * b_loc:t * b_sz + (d + 1) * b_loc],
        num_neg, rng) for d in range(n_dev)] for t in range(t_steps)]
    u_max = _bucket(max(pb.unique_nodes.shape[0]
                        for row in pbs for pb in row))
    batches = np.zeros((t_steps, n_dev, u_max), np.int32)
    labs = np.zeros((t_steps, n_dev, u_max), np.int32)
    row_masks = np.zeros((t_steps, n_dev, u_max), np.float32)
    for t in range(t_steps):
        for d in range(n_dev):
            pb = pbs[t][d]
            u = pb.unique_nodes.shape[0]
            batches[t, d, :u] = pb.unique_nodes
            labs[t, d, :pb.num_unique] = labels[
                pb.unique_nodes[:pb.num_unique]]
            row_masks[t, d, :pb.num_unique] = 1.0

    def pad_rows(arr: np.ndarray) -> np.ndarray:
        # a forced single-step epoch (train split < one grid) gives chunks
        # shorter than b_loc: zero-mask rows keep the stack rectangular
        # and contribute exactly zero loss
        b = arr.shape[0]
        if b < b_loc:
            arr = np.concatenate(
                [arr, np.zeros((b_loc - b,) + arr.shape[1:], arr.dtype)],
                axis=0)
        return arr

    pair_stack = {f: np.stack([np.stack([
        pad_rows(np.asarray(getattr(pbs[t][d], f))) for d in range(n_dev)])
        for t in range(t_steps)]) for f in PAIR_FIELDS}
    return batches, labs, row_masks, pair_stack


def rank_seed(epoch_seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s sampler in an epoch whose replicated
    seed is ``epoch_seed`` (the port's ``fold_in(key, axis_index)``)."""
    return (epoch_seed + (rank + 1) * 0x9E3779B97F4A7C15) % 2**64


# ------------------------------------------------------------------- device
def local_rows(table: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous N/P rows of a replicated table (a
    view)."""
    rows_per = table.shape[0] // world
    return table[rank * rows_per:(rank + 1) * rows_per]


def local_refresh(hop, feats: torch.Tensor, fanout: int, agg: str,
                  rank: int, world: int):
    """The leaf-cache refresh over rank ``rank``'s row range
    (``cached_dist.py:158``; work / P): (cache_local [N/P, D], cnt_local
    [N/P] float32), one ``hop`` call and one aggregate launch."""
    rows_per = feats.shape[0] // world
    aggregate = max_aggregate if agg == "MAX" else mean_aggregate
    with torch.no_grad():
        ids = torch.arange(rank * rows_per, (rank + 1) * rows_per,
                           dtype=torch.int32, device=feats.device)
        samples, valid = hop(ids, fanout)
        # self-loop samples drop out of the aggregation set, as in
        # refresh_leaf_cache
        mask = (valid & (samples != ids[:, None])).float()
        return aggregate(feats, samples, mask), mask.sum(dim=1)


def sharded_forward(params: dict, mcfg: GraphSageConfig,
                    x_local: torch.Tensor, cache_local: torch.Tensor,
                    cnt_local: torch.Tensor, ids: torch.Tensor, frontiers,
                    fanout: int = 10, group=None) -> torch.Tensor:
    """Encode this rank's batch shard (``cached_dist.py:179``): the layer-1
    GEMM over the rank's rows, ``all_gather_rows`` of the [N, H] table,
    then the rank-local upper layers over the sampled (ids, frontiers)."""
    is_max = mcfg.agg_func == "MAX"
    sage = cast_compute(params["sage"], mcfg)
    xl = cast_compute(x_local, mcfg)
    cl = cast_compute(cache_local, mcfg)
    w1 = sage["layers"][0]
    if mcfg.gcn:
        mixed = _gcn_mix(xl, cl, cnt_local, is_max)
        h1_local = sage_layer_apply(w1, mixed, mixed, gcn=True)
    else:
        h1_local = sage_layer_apply(w1, xl, cl, gcn=False)
    h1_full = comm.all_gather_rows(h1_local, group)
    h = gather_rows(h1_full, ids)
    return _upper_layers(sage, h, frontiers, fanout, mcfg.agg_func, mcfg.gcn)


@dataclasses.dataclass(frozen=True)
class CachedDistStep(CachedStep):
    """One rank's step of the sharded epochs (``make_cached_dist_epoch`` and
    ``make_cached_dist_unsup_epoch``): ``CachedStep`` with the sharded
    forward and the mean over ranks.  It takes (x_local, cache_local,
    cnt_local) where ``CachedStep`` takes the tables, and returns the mean
    of the ranks' losses."""
    group: Any = None

    def _encode(self, params, x_local, cache_local, cnt_local, ids,
                frontiers):
        return sharded_forward(params, self.mcfg, x_local, cache_local,
                               cnt_local, ids, frontiers, self.fanout,
                               self.group)

    def _update(self, params, loss):
        return apply_gradients_mean(params, loss, self.lr, self.clip,
                                    self.group)
