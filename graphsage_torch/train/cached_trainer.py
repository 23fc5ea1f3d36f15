"""CachedTrainer: the reference training protocol on the leaf-cached
pipeline (``train/cached.py``), the CLI's ``--pipeline cached``.

Port of ``graphsage_tpu/train/cached_trainer.py``.  Against the compact
``Trainer``:

- Batches are extended with walk-positive / negative pair endpoints for
  every learn method (reference src/utils.py:147-149), the loss masks
  padded rows, and evaluation keeps the best-val -> test protocol
  (src/utils.py:13-57).  ``extend_batches=False`` gives plain fixed-size
  supervised batches.
- An epoch is one leaf-cache refresh and a Python loop of steps on the
  card; the host work (shuffle, pair sampling, stacking to one bucketed U
  for the whole epoch) happens before the first step, and the epoch's
  losses are fetched once, at its end, through ``fetch_with_deadline``.
- Depth-L neighbourhoods are one uniform fanout-subset per node per epoch
  (or per ``refresh_every`` epochs); depths < L sample fresh per step, from
  a ``torch.Generator`` on the card seeded with ``seed + 1`` (the JAX
  package's ``PRNGKey(seed + 1)``).  The padded adjacency is
  ``to_padded_sampled(table_cap, RandomState(seed))``, or the full
  ``to_padded()`` without a cap.

MEAN and MAX train here, with gcn on or off, and so does the cached-LSTM
hybrid (``lstm_hybrid=True``: MEAN leaf cache, live LSTM cells above,
``train/cached.py``), in float32 or in bfloat16 with float32 master params
(the feature table and the leaf cache in bfloat16).  The exact LSTM
aggregator cannot ride the leaf cache and is refused with ``ValueError``
without that opt-in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphsage_torch.data.loaders import Dataset
from graphsage_torch.models.graphsage import GraphSageConfig
from graphsage_torch.sampler.compact import _bucket
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.cached import (CachedStep, _check_cached,
                                          cached_epoch_reuse, cached_forward,
                                          refresh_leaf_cache,
                                          sample_cached_frontiers)
from graphsage_torch.train.trainer import Trainer, TrainConfig, _to_device
from graphsage_torch.utils.obs import fetch_with_deadline

_PAIR_FIELDS = ("pos_q", "pos_mask", "neg_q", "neg_mask", "node_valid",
                "target_rows")


def _stack_pair_batches(pbs, b_sz: int, labels_np: np.ndarray,
                        device: torch.device):
    """Pad T PairBatches to common shapes and stack: extended batches
    [T, U], labels [T, U], row masks [T, U], pair tensor dict [T, ...], on
    ``device``.  U is one bucket for the whole epoch.

    Padded extension rows point at node 0 with row_mask 0; padded pair
    rows carry zero masks and node_valid 0, so every loss term they touch
    vanishes exactly."""
    t = len(pbs)
    u_max = _bucket(max(pb.unique_nodes.shape[0] for pb in pbs))
    batches = np.zeros((t, u_max), np.int32)
    labels = np.zeros((t, u_max), np.int32)
    row_masks = np.zeros((t, u_max), np.float32)
    stacked = {f: [] for f in _PAIR_FIELDS}
    for i, pb in enumerate(pbs):
        u = pb.unique_nodes.shape[0]
        batches[i, :u] = pb.unique_nodes
        labels[i, :pb.num_unique] = labels_np[
            pb.unique_nodes[:pb.num_unique]]
        row_masks[i, :pb.num_unique] = 1.0
        for f in _PAIR_FIELDS:
            arr = np.asarray(getattr(pb, f))
            b = arr.shape[0]
            if b < b_sz:  # tail batch: pad pair rows to the common B
                pad_shape = (b_sz - b,) + arr.shape[1:]
                arr = np.concatenate(
                    [arr, np.zeros(pad_shape, arr.dtype)], axis=0)
            stacked[f].append(arr)
    pair_stack = {f: _to_device(np.stack(v), device)
                  for f, v in stacked.items()}
    return (_to_device(batches, device), _to_device(labels, device),
            _to_device(row_masks, device), pair_stack)


class CachedTrainer(Trainer):
    """The Trainer protocol over the leaf-cached epochs.

    Inherits evaluation, the unsup classifier fit and ``fit`` from
    :class:`Trainer`; replaces its per-step compact path with
    ``train/cached.py``'s epochs."""

    def __init__(self, dataset: Dataset, model_cfg: GraphSageConfig,
                 train_cfg: TrainConfig, checkpoint_fn=None,
                 table_cap: int | None = None,
                 extend_batches: bool = True,
                 lstm_hybrid: bool = False,
                 params: dict | None = None,
                 device: str | torch.device | None = None):
        if model_cfg.agg_func == "LSTM" and not lstm_hybrid:
            raise ValueError(
                "the exact LSTM aggregator cannot use the leaf cache "
                "(cell parameters upstream of the cached gather); pass "
                "lstm_hybrid=True (--lstm_hybrid) for the MEAN-leaf + "
                "live-LSTM hybrid variant, or use --pipeline compact "
                "for the all-LSTM model")
        super().__init__(dataset, model_cfg, train_cfg, checkpoint_fn,
                         params=params, device=device)
        self.extend_batches = extend_batches
        rng = np.random.RandomState(train_cfg.seed)
        pad = (dataset.graph.to_padded() if table_cap is None
               else dataset.graph.to_padded_sampled(table_cap, rng))
        self.neighbors = _to_device(pad.neighbors, self.device)
        self.degrees = _to_device(pad.degrees, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(train_cfg.seed + 1)
        self.hop = HopSampler(self.neighbors, self.degrees, gen)
        tcfg = self.tcfg
        self._step = CachedStep(
            self.mcfg, learn_method=tcfg.learn_method,
            unsup_loss=tcfg.unsup_loss, fanout=tcfg.fanout, lr=tcfg.lr,
            clip=tcfg.clip_norm, q=self.pair_sampler.q,
            margin=self.pair_sampler.margin)
        # (cache_feats, cache_count) of the current epoch, held between
        # refreshes when refresh_every > 1
        self._stale_cache = None

    @staticmethod
    def _check_config(model_cfg: GraphSageConfig) -> None:
        """MEAN, MAX and the LSTM hybrid, float32 or bfloat16."""
        _check_cached(model_cfg)

    def _refresh(self):
        return refresh_leaf_cache(self.hop, self.feats, self.tcfg.fanout,
                                  agg=self.mcfg.agg_func)

    def _epoch_cache(self):
        """The leaf cache for this epoch under refresh_every=k: refreshed
        on epochs 0, k, 2k, ... and held (stale) in between."""
        if (self._stale_cache is None
                or self.epoch % self.tcfg.refresh_every == 0):
            self._stale_cache = self._refresh()
        return self._stale_cache

    # ----------------------------------------------------------- embedding
    def _embed_padded(self, nodes: np.ndarray, sage_params, cache):
        padded = np.zeros(_bucket(len(nodes)), np.int32)
        padded[:len(nodes)] = nodes
        with torch.no_grad():
            ids, frontiers = sample_cached_frontiers(
                self.hop, _to_device(padded, self.device), self.mcfg,
                self.tcfg.fanout)
            embs = cached_forward({"sage": sage_params}, self.mcfg,
                                  self.feats, *cache, ids, frontiers,
                                  self.tcfg.fanout)
        return embs.float().cpu().numpy()[:len(nodes)]

    def embed_nodes(self, nodes: np.ndarray, sage_params=None) -> np.ndarray:
        """Encode nodes through the cached forward with a FRESH leaf-cache
        draw (the reference's fresh-sampling eval, src/utils.py:27)."""
        sage_params = sage_params or self.params["sage"]
        return self._embed_padded(np.asarray(nodes), sage_params,
                                  self._refresh())

    def all_embeddings(self) -> np.ndarray:
        """Embeddings of every node with ONE fresh leaf-cache draw per call;
        the upper-layer sampling stays fresh per batch of ``emb_b_sz``."""
        n = self.ds.num_nodes
        b = self.tcfg.emb_b_sz
        cache = self._refresh()
        out = np.zeros((n, self.mcfg.out_size), np.float32)
        for lo in range(0, n, b):
            nodes = np.arange(lo, min(lo + b, n))
            out[nodes] = self._embed_padded(nodes, self.params["sage"], cache)
        return out

    # --------------------------------------------------------------- train
    def train_epoch(self) -> float:
        """One epoch; returns the mean step loss (the per-step losses are
        left in ``self.step_losses``)."""
        tcfg = self.tcfg
        order = self.rng.permutation(self.ds.train_nodes)
        b = tcfg.b_sz
        t = math.ceil(len(order) / b)
        pair_stack = None
        if tcfg.learn_method == "sup" and not self.extend_batches:
            # plain fixed-size batches; the wrap-padded tail rows are
            # masked out of the loss
            batches = np.resize(order, t * b).reshape(t, b).astype(np.int32)
            row_masks = np.ones((t, b), np.float32)
            row_masks[t - 1, len(order) - (t - 1) * b:] = 0.0
            labels = self.labels_np[batches].astype(np.int32)
            visited = len(np.unique(order))
            batches, labels, row_masks = (
                _to_device(x, self.device)
                for x in (batches, labels, row_masks))
        else:
            # extended batches for every learn method (reference
            # src/utils.py:147-149)
            pbs = [self.pair_sampler.sample_batch(
                order[i * b:(i + 1) * b], tcfg.num_neg, self.rng)
                for i in range(t)]
            batches, labels, row_masks, pair_stack = _stack_pair_batches(
                pbs, b, self.labels_np, self.device)
            visited = len({int(v) for pb in pbs
                           for v in pb.unique_nodes[:pb.num_unique]})
        # refresh_every=1 refreshes every epoch: the JAX fused epoch's
        # order (refresh, then the steps), with the cache kept on the trainer
        losses = cached_epoch_reuse(
            self._step, self.params, self.feats, *self._epoch_cache(),
            self.hop, batches, labels, row_masks, pair_stack)
        # the epoch's one synchronisation, deadline-guarded
        self.step_losses = fetch_with_deadline(
            losses, label=f"cached epoch {self.epoch} loss fetch",
            convert=torch.Tensor.tolist)
        mean_loss = float(np.mean(self.step_losses))
        self.metrics.log("epoch", epoch=self.epoch, mean_loss=mean_loss,
                         visited_nodes=visited, train_nodes=len(order),
                         pipeline="cached")
        return mean_loss
