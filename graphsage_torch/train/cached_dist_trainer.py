"""CachedDistTrainer: the reference training protocol on the sharded
leaf-cached pipeline (``train/cached_dist.py``), the CLI's ``--pipeline
cached_dist``.

Port of ``graphsage_tpu/train/cached_dist_trainer.py``.  One process a rank
of the default ``torch.distributed`` group (``parallel.multihost``); every
rank holds the replicated tables, params and host RandomState and runs the
same program on its own rows:

- ``b_sz`` is the GLOBAL batch, split b_sz // P a rank and rounded up to a
  multiple of P;
- each epoch every rank builds the global epoch stack (plain or extended
  batches, ``build_epoch_stack`` / ``build_unsup_epoch_stack``) from the
  shared RandomState and trains on its [T, b_loc] row;
- the leaf cache of the rank's N/P rows is refreshed every
  ``refresh_every`` epochs (``local_refresh``);
- the first epoch runs under ``collective_watchdog`` (a missing peer or a
  hung first collective dumps the group's diagnostics), and every epoch's
  losses come back through ``fetch_with_deadline``.

Sampling streams (the port's stand-in for JAX's replicated key with
``fold_in(axis_index)``): a replicated CPU ``torch.Generator``
(``key_generator``, seeded ``seed + 1``) draws one seed an epoch; rank r's
training sampler is seeded ``rank_seed(seed, r)`` from it, and the
evaluation sampler (``hop``) with the epoch seed itself, the same on every
rank, so every rank computes the same F1 and takes the same best-val
decisions.  A checkpoint keeps ``key_generator``'s state (PR 9's
``generator/state``), which makes a supervised resume exact at any world
size.

Evaluation, the classifier fit and checkpoint hooks are
``CachedTrainer``'s: the tables are replicated, so any one rank embeds
alone, through the single-device cached forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphsage_torch.data.loaders import Dataset
from graphsage_torch.models.graphsage import GraphSageConfig
from graphsage_torch.parallel import comm
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.cached import cached_epoch_reuse
from graphsage_torch.train.cached_dist import (CachedDistStep,
                                               build_epoch_stack,
                                               build_unsup_epoch_stack,
                                               local_refresh, local_rows,
                                               rank_seed)
from graphsage_torch.train.cached_trainer import CachedTrainer
from graphsage_torch.train.trainer import TrainConfig, _to_device
from graphsage_torch.utils.obs import collective_watchdog, fetch_with_deadline


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows`` (pad_node_tables on the
    device)."""
    if t.shape[0] == rows:
        return t
    extra = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device)
    return torch.cat([t, extra])


class CachedDistTrainer(CachedTrainer):
    """CachedTrainer protocol over the sharded epochs of the default process
    group (or ``group``), which must be formed first."""

    def __init__(self, dataset: Dataset, model_cfg: GraphSageConfig,
                 train_cfg: TrainConfig, checkpoint_fn=None,
                 table_cap: int | None = None,
                 extend_batches: bool = True,
                 lstm_hybrid: bool = False,
                 params: dict | None = None,
                 device: str | torch.device | None = None,
                 group=None):
        self.group = group
        self.rank, self.world = comm.rank_world(group)
        if train_cfg.b_sz % self.world:
            train_cfg = dataclasses.replace(
                train_cfg,
                b_sz=-(-train_cfg.b_sz // self.world) * self.world)
        super().__init__(dataset, model_cfg, train_cfg,
                         checkpoint_fn=checkpoint_fn, table_cap=table_cap,
                         extend_batches=extend_batches,
                         lstm_hybrid=lstm_hybrid, params=params,
                         device=device)
        # the node tables padded to a multiple of P rows (degree 0 rows:
        # never sampled; zero cache and h1 rows)
        n_pad = -(-self.feats.shape[0] // self.world) * self.world
        self.feats = _pad_rows(self.feats, n_pad)
        self.neighbors = _pad_rows(self.neighbors, n_pad)
        self.degrees = _pad_rows(self.degrees, n_pad)
        self.x_local = local_rows(self.feats, self.rank, self.world)
        self.key_generator = torch.Generator().manual_seed(train_cfg.seed + 1)
        self.hop = HopSampler(self.neighbors, self.degrees,
                              torch.Generator(device=self.device))
        self.rank_hop = HopSampler(self.neighbors, self.degrees,
                                   torch.Generator(device=self.device))
        tcfg = self.tcfg
        self._dist_step = CachedDistStep(
            self.mcfg, learn_method=tcfg.learn_method,
            unsup_loss=tcfg.unsup_loss, fanout=tcfg.fanout, lr=tcfg.lr,
            clip=tcfg.clip_norm, q=self.pair_sampler.q,
            margin=self.pair_sampler.margin, group=group)

    def _reseed(self) -> None:
        """One replicated seed an epoch: rank r's training stream and the
        replicated evaluation stream."""
        seed = int(torch.randint(0, 2**62, (1,),
                                 generator=self.key_generator))
        self.rank_hop.generator.manual_seed(rank_seed(seed, self.rank))
        self.hop.generator.manual_seed(seed)

    def _epoch_cache(self):
        """This rank's (cache_local, cnt_local): refreshed on epochs 0, k,
        2k, ... under refresh_every=k and held (stale) in between."""
        if (self._stale_cache is None
                or self.epoch % self.tcfg.refresh_every == 0):
            self._stale_cache = local_refresh(
                self.rank_hop, self.feats, self.tcfg.fanout,
                "MAX" if self.mcfg.agg_func == "MAX" else "MEAN",
                self.rank, self.world)
        return self._stale_cache

    def _rank_rows(self, *arrays):
        return [_to_device(a[:, self.rank], self.device) for a in arrays]

    def _run_epoch(self, batches, labels, row_masks, pair_stack):
        losses = cached_epoch_reuse(
            self._dist_step, self.params, self.x_local,
            *self._epoch_cache(), self.rank_hop, batches, labels,
            row_masks, pair_stack)
        return fetch_with_deadline(
            losses, label=f"cached_dist epoch {self.epoch} loss fetch",
            convert=torch.Tensor.tolist)

    def train_epoch(self) -> float:
        tcfg = self.tcfg
        self._reseed()
        pair_stack = None
        if tcfg.learn_method == "sup" and not self.extend_batches:
            stack = build_epoch_stack(self.ds.train_nodes, self.labels_np,
                                      self.world, tcfg.b_sz, self.rng)
            visited = len(np.unique(self.ds.train_nodes))
            batches, labels, row_masks = self._rank_rows(*stack)
        else:
            *stack, pairs = build_unsup_epoch_stack(
                self.pair_sampler, self.ds.train_nodes, self.labels_np,
                self.world, tcfg.b_sz, tcfg.num_neg, self.rng)
            visited = len(np.unique(stack[0][stack[2] > 0]))
            batches, labels, row_masks = self._rank_rows(*stack)
            if tcfg.learn_method != "sup":
                # extended supervised batches take the NLL over the pair
                # endpoints' union only; the pair tensors go unused
                pair_stack = dict(zip(pairs, self._rank_rows(
                    *pairs.values())))
        args = (batches, labels, row_masks, pair_stack)
        if self._warmed:
            self.step_losses = self._run_epoch(*args)
        else:
            with collective_watchdog(
                    label="CachedDistTrainer first sharded epoch",
                    group=self.group):
                self.step_losses = self._run_epoch(*args)
            self._warmed = True
        mean_loss = float(np.mean(self.step_losses))
        self.metrics.log("epoch", epoch=self.epoch, mean_loss=mean_loss,
                         visited_nodes=int(visited),
                         train_nodes=len(self.ds.train_nodes),
                         pipeline="cached_dist",
                         steps=len(self.step_losses), n_dev=self.world)
        return mean_loss
