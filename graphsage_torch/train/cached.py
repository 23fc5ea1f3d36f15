"""The leaf-cached training pipeline, on the card.

Port of ``graphsage_tpu/train/cached.py``.  Per EPOCH (or every
``refresh_every`` epochs) one uniform ``fanout``-subset is drawn per node
and the depth-L aggregation of the RAW features is cached:

    cache_feats[v] = mean (or elementwise max) of feats over v's subset

(``refresh_leaf_cache``: one ``gather_mean`` / ``gather_max`` launch over
all N rows).  Per STEP fresh frontiers are sampled for depths 0..L-2 only,
and layer 1 for a frontier node v is relu(W1 · [feats[v] ‖ cache[v]]):
row gathers from tables that carry no gradient (``gather_rows``, the
hand-written CUDA kernel), or one gather of the transformed full table,
chosen by the JAX package's byte model (``layer1_full_table``, verbatim).
Layers 2..L aggregate the tree-contiguous frontiers with a reshape and a
masked reduce, with no index ops.

Sampling goes through a hop sampler (``graphsage_torch.sampler.device``):
the step samples first, then calls the forward, so a test can replay the
JAX package's draws and a run on the card can record its own.  The JAX
package's ``lax.scan`` epochs are Python step loops here
(``cached_epoch_reuse`` after ``refresh_leaf_cache``, covering the four
JAX epochs, sup and unsup by the step's ``learn_method``); parameters are
leaf tensors updated in place.

Aggregators: MEAN (gcn mixes the cached mean with self by count, exactly),
MAX (the cache is an elementwise max; its refresh has no gradient, and the
upper layers reduce with ``torch.amax``, which splits the gradient equally
among tied maxima as ``jnp.max`` does) and LSTM as the cached-LSTM hybrid
(``graphsage_tpu/train/cached.py:40-52``): the leaf level is the MEAN
cache, and the live LSTM cell of each upper layer scans its tree-contiguous
[U, K+1, H] reshape (``lstm_scan``, no gather).  The layer-0 cell is never
used and gets a zero gradient.

bfloat16 compute: ``cached_forward`` rounds the params, the feature table
and the cache to bfloat16 with ``train.dense.cast_compute`` (JAX
``cached.py:153-155``); the refresh aggregates the bfloat16 table with
float32 sums inside ``gather_mean`` / ``gather_max``, and the upper MEAN
layers take a bfloat16 ``einsum`` rounded to bfloat16 and divided by a
bfloat16 count, JAX's cast points.
"""

from __future__ import annotations

import dataclasses

import torch

from graphsage_torch.losses import supervised_nll, unsup_loss_from_pairbatch
from graphsage_torch.models.graphsage import (GraphSageConfig, compute_dtype,
                                              refuse_pool)
from graphsage_torch.models.layers import classifier_apply, sage_layer_apply
from graphsage_torch.models.lstm_agg import lstm_scan
from graphsage_torch.ops.aggregate import max_aggregate, mean_aggregate
from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.sampler.device import sample_frontiers_dense
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.optim import apply_gradients
from graphsage_torch.utils.obs import span


def _check_cached(mcfg: GraphSageConfig) -> None:
    """MEAN, MAX and LSTM (the hybrid), in float32 or bfloat16."""
    refuse_pool(mcfg, "the cached pipelines")
    if mcfg.agg_func not in ("MEAN", "MAX", "LSTM"):
        raise ValueError(f"unknown agg_func {mcfg.agg_func!r}")
    compute_dtype(mcfg)


def refresh_leaf_cache(hop, feats: torch.Tensor, fanout: int,
                       agg: str = "MEAN"):
    """Per-epoch cache refresh on the device.

    Returns (cache_feats [N, D], cache_count [N] float32): the masked mean
    (or elementwise max, ``agg="MAX"``) of the raw features over a fresh
    uniform ``fanout``-subset per node from ``hop``, and the number of
    valid slots.  Self-loop samples drop out.  One ``hop`` call and one
    aggregate launch over all N rows: the kernels never build the
    [N, fanout, D] gather that the JAX package blocks its refresh to bound
    (``cached.py:107-125``)."""
    n = feats.shape[0]
    aggregate = max_aggregate if agg == "MAX" else mean_aggregate
    with torch.no_grad():
        ids = torch.arange(n, dtype=torch.int32, device=feats.device)
        samples, valid = hop(ids, fanout)
        # self-loop samples drop out of the aggregation set, matching the
        # dense sampler's not_self mask (src/models.py:285,297-298)
        mask = (valid & (samples != ids[:, None])).float()
        return aggregate(feats, samples, mask), mask.sum(dim=1)


def _gcn_mix(self_f: torch.Tensor, agg_f: torch.Tensor, cnt: torch.Tensor,
             is_max: bool) -> torch.Tensor:
    """gcn aggregates over sample ∪ self (src/models.py:297-298): the exact
    count-weighted mix of the cached mean, or one more elementwise max for
    MAX (an empty sample gives self alone)."""
    if cnt.dim() == self_f.dim() - 1:
        cnt = cnt[..., None]
    cnt = cnt.to(self_f.dtype)
    if is_max:
        return torch.where(cnt > 0, torch.maximum(agg_f, self_f), self_f)
    return (cnt * agg_f + self_f) / (cnt + 1.0)


def layer1_full_table(n: int, feat_dim: int, m1: int, hdim1: int) -> bool:
    """The JAX package's layer-1 branch rule (``cached.py:182-193``),
    verbatim: transform the full table and gather H-wide rows when
    n·2D/16 + 3·m1·H < m1·2D, else gather the D-wide rows of both tables
    per occurrence.  Both branches move both tables, so gcn counts 2D too.
    It is a TPU byte model, kept for parity; the port's own crossover waits
    for the H100 rates (ROADMAP)."""
    feat2 = 2 * feat_dim
    return n * feat2 / 16 + 3 * m1 * hdim1 < m1 * feat2


def sample_cached_frontiers(hop, batch: torch.Tensor, mcfg: GraphSageConfig,
                            fanout: int = 10):
    """(ids [m1] int32, frontiers): the frontiers of depths 0..L-2 for the
    batch, whose bottom ids take layer 1 from the cache."""
    if mcfg.num_layers == 1:
        return batch.to(torch.int32), []
    return sample_frontiers_dense(hop, batch, num_layers=mcfg.num_layers - 1,
                                  fanout=fanout, gcn=mcfg.gcn)


def cached_forward(params: dict, mcfg: GraphSageConfig, feats: torch.Tensor,
                   cache_feats: torch.Tensor, cache_count: torch.Tensor,
                   ids: torch.Tensor, frontiers, fanout: int = 10,
                   full_table: bool | None = None) -> torch.Tensor:
    """Encode the batch whose sampled frontiers are (ids, frontiers):
    -> [B, out_size].  ``feats``/``cache_feats``/``cache_count`` are the
    epoch-constant tables.  ``full_table`` forces the layer-1 branch (both
    are exact); by default ``layer1_full_table`` decides, as in the JAX
    package.  Under bfloat16 the params, ``feats`` and ``cache_feats`` are
    rounded to it here."""
    _check_cached(mcfg)
    is_max = mcfg.agg_func == "MAX"
    sage = cast_compute(params["sage"], mcfg)
    feats = cast_compute(feats, mcfg)
    cache_feats = cast_compute(cache_feats, mcfg)
    w1 = sage["layers"][0]
    if full_table is None:
        full_table = layer1_full_table(feats.shape[0], feats.shape[1],
                                       ids.shape[0], w1["weight"].shape[0])
    with span("step.layer1", device=feats.device,
              full_table=int(full_table)):
        if mcfg.gcn:
            if full_table:
                mixed_t = _gcn_mix(feats, cache_feats, cache_count, is_max)
                h1_table = sage_layer_apply(w1, mixed_t, mixed_t, gcn=True)
                h = gather_rows(h1_table, ids)
            else:
                self_f = gather_rows(feats, ids)
                agg_f = gather_rows(cache_feats, ids)
                mixed = _gcn_mix(self_f, agg_f, cache_count[ids.long()],
                                 is_max)
                h = sage_layer_apply(w1, mixed, mixed, gcn=True)
        elif full_table:
            h1_table = sage_layer_apply(w1, feats, cache_feats, gcn=False)
            h = gather_rows(h1_table, ids)
        else:
            h = sage_layer_apply(w1, gather_rows(feats, ids),
                                 gather_rows(cache_feats, ids), gcn=False)
    return _upper_layers(sage, h, frontiers, fanout, mcfg.agg_func, mcfg.gcn)


def _upper_layers(sage: dict, h: torch.Tensor, frontiers, fanout: int,
                  agg_func: str, gcn: bool) -> torch.Tensor:
    """Layers 2..L: the dense tree keeps parent u's children at rows
    [u·(K+1), (u+1)·(K+1)) with slot 0 = self, so aggregation is a reshape
    and a masked reduce (or, for LSTM, the layer's cell scanning the
    reshape), with no index ops."""
    k = fanout
    for li, frontier in enumerate(frontiers, start=1):
        hr = h.reshape(-1, k + 1, h.shape[1])
        mask = frontier.mask.to(h.dtype)                       # [U, K+1]
        if agg_func == "MAX":
            # a Python scalar: a tensor made from one on the card would be
            # a host-to-device copy, which waits for the device
            agg = torch.amax(torch.where(mask[..., None] > 0, hr,
                                         float("-inf")), dim=1)
            any_valid = (mask > 0).any(dim=1, keepdim=True)
            agg = torch.where(any_valid, agg, torch.zeros_like(agg))
        elif agg_func == "LSTM":
            agg = lstm_scan(sage["agg"][li], hr, mask)
        else:
            cnt = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
            agg = torch.einsum("ukh,uk->uh", hr, mask) / cnt
        h = sage_layer_apply(sage["layers"][li], hr[:, 0], agg, gcn=gcn)
    return h


@dataclasses.dataclass(frozen=True)
class CachedStep:
    """One step of the leaf-cached pipeline (``make_cached_sup_step`` and
    ``make_cached_unsup_step``): sample the upper frontiers from ``hop``,
    forward, loss, backward, per-model clip, SGD on ``params`` in place.
    ``learn_method`` "sup" takes the supervised loss; "unsup" the pair
    loss; "plus_unsup" both."""
    mcfg: GraphSageConfig
    learn_method: str = "sup"
    unsup_loss: str = "normal"
    fanout: int = 10
    lr: float = 0.7
    clip: float = 5.0
    q: float = 10.0
    margin: float = 3.0

    def __call__(self, params: dict, feats, cache_feats, cache_count, hop,
                 batch, labels, row_mask=None, pairs=None) -> torch.Tensor:
        """Returns the loss, a device scalar (not synchronised)."""
        with span("step.sample"):
            ids, frontiers = sample_cached_frontiers(hop, batch, self.mcfg,
                                                     self.fanout)
        with span("step.forward"):
            embs = self._encode(params, feats, cache_feats, cache_count, ids,
                                frontiers)
            if row_mask is None:
                row_mask = torch.ones(embs.shape[0], device=embs.device)
            loss = None
            if self.learn_method != "sup":
                loss = unsup_loss_from_pairbatch(
                    embs, pairs, self.unsup_loss, q=self.q,
                    margin=self.margin)
            if self.learn_method != "unsup":
                logp = classifier_apply(
                    cast_compute(params["clf"], self.mcfg), embs)
                sup = supervised_nll(logp, labels, row_mask)
                loss = sup if loss is None else loss + sup
        return self._update(params, loss)

    def _encode(self, params, feats, cache_feats, cache_count, ids,
                frontiers):
        return cached_forward(params, self.mcfg, feats, cache_feats,
                              cache_count, ids, frontiers, self.fanout)

    def _update(self, params, loss):
        apply_gradients(params, loss, ("sage", "clf"), self.lr, self.clip)
        return loss.detach()


def cached_epoch_reuse(step, params: dict, feats, cache_feats, cache_count,
                       hop, batches, labels, row_masks=None,
                       pair_stack=None) -> torch.Tensor:
    """The epoch on a caller-held cache (``make_cached_sup_epoch_reuse`` /
    ``make_cached_unsup_epoch_reuse``): ``step`` over the T rows of
    ``batches`` [T, B], ``labels`` [T, B], ``row_masks`` [T, B] and the
    [T, ...] fields of ``pair_stack``.  Returns the step losses [T] on the
    device."""
    losses = []
    for t in range(batches.shape[0]):
        pairs = (None if pair_stack is None
                 else {f: v[t] for f, v in pair_stack.items()})
        losses.append(step(params, feats, cache_feats, cache_count, hop,
                           batches[t], labels[t],
                           None if row_masks is None else row_masks[t],
                           pairs))
    return torch.stack(losses)

