"""Distributed training: edge-partitioned features, halo exchange, and the
data-parallel gradient mean.

Port of ``graphsage_tpu/train/distributed.py``.  Nodes are partitioned into
contiguous ranges over the ranks of a ``torch.distributed`` group and the
feature table is sharded row-wise (``parallel/halo.py``); each rank trains
on its own batch shard:

- the host samples every rank's dense per-occurrence frontiers through the
  native C++ engine (:func:`sample_dense_host`, seeds ``seed + d * 7919``
  for rank d), and plans the halo exchange (:func:`build_dist_batch`);
  every rank builds the whole [P, ...] batch from the shared RandomState,
  as the JAX package does from one process, and takes its row;
- the layer-0 rows come over the two-phase all_to_all halo exchange; with
  the MEAN pretransform (MEAN, not gcn) each rank first transforms its own
  rows by W1, so the payload is [·, 2H] instead of [·, D] and layer 1 is a
  masked mean and a relu;
- everything after the exchange is rank-local, and the update is the mean
  over ranks of the float32 gradients, the clip and SGD
  (``train.optim.apply_gradients_mean``, JAX's ``pmean`` inside the loss).

There is no numpy fallback for the sampler: a failed engine build raises
(ROADMAP C), where the JAX package falls back and changes its stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.losses import supervised_nll, unsup_loss_from_pairbatch
from graphsage_torch.models.graphsage import (Frontier, GraphSageConfig,
                                              graphsage_apply)
from graphsage_torch.models.layers import (classifier_apply,
                                           mean_pretransform,
                                           sage_layer_apply)
from graphsage_torch.native import sample_fanout_native
from graphsage_torch.ops.aggregate import mean_aggregate
from graphsage_torch.ops.scatter import take_rows
from graphsage_torch.parallel.halo import halo_gather_local, plan_halo
from graphsage_torch.parallel.multihost import local_batch_rows
from graphsage_torch.train.cached_trainer import PAIR_FIELDS
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.optim import apply_gradients_mean


# --------------------------------------------------------------------- host
def sample_dense_host(graph: CSRGraph, batch: np.ndarray, num_layers: int,
                      fanout: int, seed: int, gcn: bool = False):
    """Host-side dense per-occurrence frontier expansion (the device
    sampler's layout) through the native fanout sampler.  batch: [M0] node
    ids.  Returns (x0_ids [M0·(K+1)^L], frontiers: bottom-up numpy
    Frontiers)."""
    k = fanout
    level_nodes = [np.asarray(batch, dtype=np.int32)]
    level_valid = []
    for depth in range(num_layers):
        nodes = level_nodes[-1]
        samples, counts = sample_fanout_native(
            graph.indptr, graph.indices, graph.num_nodes, nodes, k,
            seed + depth * 1000003)
        valid = (np.arange(k)[None, :] < counts[:, None])
        valid &= samples != nodes[:, None]
        children = np.concatenate([nodes[:, None], samples], axis=1)
        level_valid.append(valid.astype(np.float32))
        level_nodes.append(children.reshape(-1))

    frontiers = []
    for depth in range(num_layers - 1, -1, -1):
        m = len(level_nodes[depth])
        base = (np.arange(m, dtype=np.int32) * (k + 1))
        neigh_idx = base[:, None] + 1 + np.arange(k, dtype=np.int32)[None]
        idx = np.concatenate([base[:, None], neigh_idx], axis=1)
        mask = np.concatenate(
            [np.full((m, 1), 1.0 if gcn else 0.0, np.float32),
             level_valid[depth]], axis=1)
        frontiers.append(Frontier(idx=idx, mask=mask, self_idx=base))
    return level_nodes[-1], frontiers


@dataclasses.dataclass(frozen=True)
class DistBatch:
    """Host arrays of one distributed step, leading axis = rank."""
    requests: np.ndarray       # [n_dev, n_dev, cap]
    addr_owner: np.ndarray     # [n_dev, u0_loc]
    addr_slot: np.ndarray      # [n_dev, u0_loc]
    addr_is_local: np.ndarray  # [n_dev, u0_loc]
    addr_local: np.ndarray     # [n_dev, u0_loc]
    frontiers: list            # numpy Frontiers stacked [n_dev, ...]
    labels: np.ndarray         # [n_dev, b_loc]
    row_mask: np.ndarray       # float32 [n_dev, b_loc]; 0 for padded rows
    # global layer-0 ids per rank (host only: lets a test or a check replay
    # a shard's forward without the halo exchange)
    x0_ids: np.ndarray | None = None


def build_dist_batch(graph: CSRGraph, labels: np.ndarray,
                     batch_per_dev: np.ndarray, num_layers: int, fanout: int,
                     seed: int, gcn: bool = False,
                     cap: int | None = None,
                     valid: np.ndarray | None = None) -> DistBatch:
    """batch_per_dev: [n_dev, b_loc] node ids.  ``valid`` (same shape,
    bool) marks real rows; the padded tail's repeats get loss weight 0."""
    n_dev, _ = batch_per_dev.shape
    x0_list, frontier_list = [], None
    for d in range(n_dev):
        x0_ids, frontiers = sample_dense_host(
            graph, batch_per_dev[d], num_layers, fanout,
            seed + d * 7919, gcn)
        x0_list.append(x0_ids)
        if frontier_list is None:
            frontier_list = [[] for _ in frontiers]
        for i, f in enumerate(frontiers):
            frontier_list[i].append(f)

    x0_per_dev = np.stack(x0_list)                       # [n_dev, u0_loc]
    plan = plan_halo(x0_per_dev, graph.num_nodes, n_dev, cap=cap)
    stacked = [Frontier(idx=np.stack([f.idx for f in fl]),
                        mask=np.stack([f.mask for f in fl]),
                        self_idx=np.stack([f.self_idx for f in fl]))
               for fl in frontier_list]
    row_mask = (np.ones(batch_per_dev.shape, np.float32) if valid is None
                else np.asarray(valid, np.float32))
    return DistBatch(requests=plan.requests, addr_owner=plan.addr_owner,
                     addr_slot=plan.addr_slot,
                     addr_is_local=plan.addr_is_local,
                     addr_local=plan.addr_local, frontiers=stacked,
                     labels=labels[batch_per_dev].astype(np.int32),
                     row_mask=row_mask, x0_ids=x0_per_dev)


def build_dist_unsup_batch(graph: CSRGraph, labels: np.ndarray,
                           pair_sampler, batch_per_dev: np.ndarray,
                           num_layers: int, fanout: int, num_neg: int,
                           seed: int, gcn: bool = False,
                           cap: int | None = None,
                           target_valid: np.ndarray | None = None):
    """Unsup/plus_unsup distributed batch: per rank, extend the batch with
    walk-positive / negative pair endpoints (reference
    src/models.py:135-148), then plan the halo over the extended batches,
    re-padded to one common width (row_mask marks real rows).

    Returns (DistBatch, pairs {field: [n_dev, ...]}); pair rows index each
    rank's extended batch.  ``target_valid`` ([n_dev, b_loc] bool) zeroes
    the pair terms (node_valid) of a wrap-padded tail's repeats."""
    n_dev, _ = batch_per_dev.shape
    rng = np.random.RandomState(seed & 0x7fffffff)
    pbs = [pair_sampler.sample_batch(batch_per_dev[d], num_neg, rng)
           for d in range(n_dev)]
    u_pad = max(len(pb.unique_nodes) for pb in pbs)
    ext = np.zeros((n_dev, u_pad), np.int64)
    valid = np.zeros((n_dev, u_pad), bool)
    for d, pb in enumerate(pbs):
        ext[d, :len(pb.unique_nodes)] = pb.unique_nodes
        valid[d, :pb.num_unique] = True
    db = build_dist_batch(graph, labels, ext, num_layers, fanout,
                          seed=seed + 7919, gcn=gcn, cap=cap, valid=valid)
    pairs = {k: np.stack([np.asarray(getattr(pb, k)) for pb in pbs])
             for k in PAIR_FIELDS}
    if target_valid is not None:
        pairs["node_valid"] = (
            pairs["node_valid"] * target_valid.astype(np.float32))
    return db, pairs


def _dev(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def dist_batch_to_device(db: DistBatch, device, group=None) -> dict:
    """This rank's row of a DistBatch (``multihost.local_batch_rows``) as
    tensors on ``device``: the step's batch argument."""
    own = lambda a: _dev(local_batch_rows(a, group), device)
    return {
        "requests": own(db.requests),
        "addr_owner": own(db.addr_owner),
        "addr_slot": own(db.addr_slot),
        "addr_is_local": own(db.addr_is_local),
        "addr_local": own(db.addr_local),
        "frontiers": [Frontier(idx=own(f.idx), mask=own(f.mask),
                               self_idx=own(f.self_idx))
                      for f in db.frontiers],
        "labels": own(db.labels),
        "row_mask": own(db.row_mask),
    }


def pairs_to_device(pairs: dict, device, group=None) -> dict:
    """This rank's row of the stacked pair arrays, on ``device``."""
    return {k: _dev(local_batch_rows(pairs[k], group), device)
            for k in PAIR_FIELDS}


# ------------------------------------------------------------------- device
def _halo(x_local: torch.Tensor, t: dict, group) -> torch.Tensor:
    return halo_gather_local(x_local, t["requests"], t["addr_owner"],
                             t["addr_slot"], t["addr_is_local"],
                             t["addr_local"], group)


def _encode_local(p: dict, mcfg: GraphSageConfig, use_pre: bool,
                  feats_local: torch.Tensor, t: dict,
                  group=None) -> torch.Tensor:
    """One rank's encode (``distributed.py:152-180``): halo-gather the
    layer-0 rows (pretransformed by W1 with ``use_pre``, so the payload is
    [·, 2H]), then the bottom-up layers."""
    frontiers = t["frontiers"]
    if not use_pre:
        return graphsage_apply(p["sage"], mcfg, _halo(feats_local, t, group),
                               frontiers)
    w = p["sage"]["layers"][0]["weight"]               # [H, 2D]
    h_local = mean_pretransform(w, feats_local)         # [rows, 2H]
    x0t = _halo(h_local, t, group)                      # [u0, 2H]
    hdim = w.shape[0]
    f0 = frontiers[0]
    agg = mean_aggregate(x0t[:, hdim:], f0.idx, f0.mask)
    h = torch.relu(agg + take_rows(x0t[:, :hdim], f0.self_idx))
    for layer in range(1, mcfg.num_layers):
        fl = frontiers[layer]
        agg = mean_aggregate(h, fl.idx, fl.mask)
        h = sage_layer_apply(p["sage"]["layers"][layer],
                             take_rows(h, fl.self_idx), agg, gcn=False)
    return h


def _pretransformed(mcfg: GraphSageConfig) -> bool:
    """The steps send W1's transform of the rows for MEAN, not gcn (the
    JAX package's default ``pretransform="auto"``)."""
    return mcfg.agg_func == "MEAN" and not mcfg.gcn


def make_dist_sup_step(mcfg: GraphSageConfig, lr: float = 0.7,
                       clip: float = 5.0, group=None):
    """One rank's supervised step: ``step(params, feats_local, t) -> loss``,
    ``t`` the rank's ``dist_batch_to_device``; the replicated params are
    updated in place and the mean of the ranks' losses returned (a device
    scalar).  MEAN (not gcn) sends the pretransformed [·, 2H] rows over
    the exchange; gradients reach W1 through the all_to_all's transpose.
    In bfloat16 the params and the features are rounded inside the loss
    (``cast_compute``)."""
    use_pre = _pretransformed(mcfg)

    def step(params, feats_local, t):
        p = cast_compute(params, mcfg)
        embs = _encode_local(p, mcfg, use_pre,
                             cast_compute(feats_local, mcfg), t, group)
        logp = classifier_apply(p["clf"], embs)
        loss = supervised_nll(logp, t["labels"], t["row_mask"])
        return apply_gradients_mean(params, loss, lr, clip, group)

    return step


def make_dist_unsup_step(mcfg: GraphSageConfig, unsup_loss: str = "normal",
                         learn_method: str = "unsup", lr: float = 0.7,
                         clip: float = 5.0, q: float = 10.0,
                         margin: float = 3.0, group=None):
    """One rank's unsup / plus_unsup step (reference dispatch
    src/utils.py:159-181): ``step(params, feats_local, t, pairs) -> loss``,
    the pair loss (the ``pair_scores`` kernel's score block), plus the NLL
    over the extended batch for plus_unsup, then the update of
    :func:`make_dist_sup_step`."""
    use_pre = _pretransformed(mcfg)

    def step(params, feats_local, t, pairs):
        p = cast_compute(params, mcfg)
        embs = _encode_local(p, mcfg, use_pre,
                             cast_compute(feats_local, mcfg), t, group)
        loss = unsup_loss_from_pairbatch(embs, pairs, unsup_loss, q=q,
                                         margin=margin)
        if learn_method == "plus_unsup":
            logp = classifier_apply(p["clf"], embs)
            loss = loss + supervised_nll(logp, t["labels"], t["row_mask"])
        return apply_gradients_mean(params, loss, lr, clip, group)

    return step


def make_dist_forward(mcfg: GraphSageConfig, group=None):
    """The evaluation forward (``dist_trainer.py:40``):
    ``fwd(sage_params, feats_local, t) -> [b_loc, out_size]``, this rank's
    rows, over the raw-feature exchange, without a gradient.  Nothing is
    rounded to the compute dtype: ``DistTrainer`` passes its float32 master
    params and float32 feature shard, as the JAX trainer does, so a
    bfloat16 model is evaluated in float32 there too."""
    def fwd(sage_params, feats_local, t):
        with torch.no_grad():
            return graphsage_apply(sage_params, mcfg,
                                   _halo(feats_local, t, group),
                                   t["frontiers"])

    return fwd
