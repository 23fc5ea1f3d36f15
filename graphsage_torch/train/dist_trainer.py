"""DistTrainer: the reference training protocol over the edge-partitioned
pipeline (``train/distributed.py``), the CLI's ``--pipeline dist``.

Port of ``graphsage_tpu/train/dist_trainer.py``: locality reorder (BFS,
``parallel/partition.py``), the feature table sharded row-wise over the
ranks (each rank holds its own rows only), the per-step host frontiers and
halo plan built on a prefetch thread (C++ sampler), the halo step, and the
best-val -> test evaluation through the distributed forward.  One process
a rank of the default ``torch.distributed`` group (``parallel.multihost``):
every rank holds the replicated params and RandomState, builds every
rank's batch and takes its row, so the ranks stay in step.

The first step runs under ``collective_watchdog``, and every loss comes
back through ``fetch_with_deadline``: the previous step's loss is fetched
before the next step's copies to the device (a copy from pageable memory
waits for the device, outside any deadline).  Evaluation all-gathers the
embedding rows, so every rank computes the same F1 and takes the same
best-val decisions; ``checkpoint_fn`` fires on every rank alike (the CLI
writes on rank 0 only).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from graphsage_torch.data.loaders import Dataset
from graphsage_torch.infer import _resolve_device
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models.graphsage import (GraphSageConfig, init_graphsage,
                                              refuse_pool)
from graphsage_torch.models.layers import classifier_apply, init_classifier
from graphsage_torch.parallel import comm
from graphsage_torch.parallel.halo import partition_bounds, shard_features
from graphsage_torch.parallel.partition import bfs_reorder, relabel_dataset
from graphsage_torch.sampler import PairSampler
from graphsage_torch.train.dense import edges_per_batch
from graphsage_torch.train.distributed import (build_dist_batch,
                                               build_dist_unsup_batch,
                                               dist_batch_to_device,
                                               make_dist_forward,
                                               make_dist_sup_step,
                                               make_dist_unsup_step,
                                               pairs_to_device)
from graphsage_torch.train.metrics import micro_f1
from graphsage_torch.train.optim import apply_gradients
from graphsage_torch.train.trainer import _leaf_params, _to_device
from graphsage_torch.utils.obs import (MetricsLogger, collective_watchdog,
                                       fetch_with_deadline,
                                       maybe_inject_test_wedge)
from graphsage_torch.utils.prefetch import Prefetcher, prefetch


@dataclasses.dataclass
class DistTrainConfig:
    learn_method: str = "sup"   # sup | unsup | plus_unsup
    unsup_loss: str = "normal"  # normal | margin
    b_loc: int = 128            # batch per rank
    epochs: int = 10
    lr: float = 0.7
    clf_lr: float = 0.5
    clip: float = 5.0
    fanout: int = 10
    seed: int = 824
    clf_epochs: int = 60        # classifier-only fit (unsup)
    clf_b_sz: int = 50
    verbose: bool = True
    # build step i+1's frontiers and halo plan on a worker thread while the
    # device runs step i; 0 builds serially
    prefetch_depth: int = 2
    metrics_path: str | None = None  # jsonl metrics sink (utils/obs.py)

    @property
    def num_neg(self) -> int:
        return 6 if self.unsup_loss == "margin" else 100


class DistTrainer:
    def __init__(self, dataset: Dataset, mcfg: GraphSageConfig,
                 tcfg: DistTrainConfig, checkpoint_fn=None,
                 params: dict | None = None,
                 device: str | torch.device | None = None, group=None):
        """``checkpoint_fn(trainer, test_f1)`` fires on each val-F1
        improvement.  ``params``: the initial {"sage", "clf"} pytree; by
        default drawn from a ``torch.Generator`` seeded ``tcfg.seed`` (the
        same on every rank)."""
        refuse_pool(mcfg, "the dist pipeline")
        self.checkpoint_fn = checkpoint_fn
        self.group = group
        self.rank, self.world = comm.rank_world(group)
        self.device = _resolve_device(device)
        dataset = relabel_dataset(dataset, bfs_reorder(dataset.graph))
        self.ds = dataset
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.rng = np.random.RandomState(tcfg.seed)
        if params is None:
            gen = torch.Generator().manual_seed(tcfg.seed)
            params = {"sage": init_graphsage(gen, mcfg),
                      "clf": init_classifier(gen, mcfg.out_size,
                                             dataset.num_classes)}
        self.params = _leaf_params(params, self.device)
        rows_per = partition_bounds(dataset.num_nodes, self.world)
        own = shard_features(dataset.features, self.world)[
            self.rank * rows_per:(self.rank + 1) * rows_per]
        # float32, as the JAX trainer holds it: the steps round it to the
        # compute dtype inside the loss, evaluation reads it unrounded
        self.feats_local = _to_device(own.astype(np.float32), self.device)
        self._step = make_dist_sup_step(mcfg, lr=tcfg.lr, clip=tcfg.clip,
                                        group=group)
        if tcfg.learn_method != "sup":
            self.pair_sampler = PairSampler(dataset.graph,
                                            dataset.train_nodes)
            self.pair_sampler.prewarm_async(dataset.train_nodes)
            self._unsup_step = make_dist_unsup_step(
                mcfg, unsup_loss=tcfg.unsup_loss,
                learn_method=tcfg.learn_method, lr=tcfg.lr, clip=tcfg.clip,
                q=self.pair_sampler.q, margin=self.pair_sampler.margin,
                group=group)
        self._fwd = make_dist_forward(mcfg, group)
        self.max_vali_f1 = 0.0
        self.epoch = 0
        self.history: list[dict] = []
        self.step_losses: list[float] = []
        self._warmed = False  # the first sharded step runs under a watchdog
        self.metrics = MetricsLogger(tcfg.metrics_path)

    def _run_step(self, step_fn, *args) -> torch.Tensor:
        """One sharded step; the first under the collective watchdog, its
        loss fetched inside it."""
        if self._warmed:
            return step_fn(*args)
        with collective_watchdog(
                label=f"{type(self).__name__} first sharded step",
                group=self.group):
            loss = step_fn(*args)
            fetch_with_deadline(loss, label="dist step 1 loss fetch "
                                            "(warmup)")
        self._warmed = True
        return loss

    # ---------------------------------------------------------------- train
    def _build_step_batch(self, chunk: np.ndarray, per_step: int):
        """Host side of one step (numpy and the C++ sampler): tail padding,
        frontiers, halo plan.  Runs on the prefetch thread and consumes
        self.rng in order."""
        tcfg = self.tcfg
        real = len(chunk)
        if real < per_step:  # pad the tail step with repeats
            chunk = np.resize(chunk, per_step)
        batch = chunk.reshape(self.world, tcfg.b_loc)
        valid = (np.arange(per_step) < real).reshape(self.world, tcfg.b_loc)
        if tcfg.learn_method == "sup":
            return build_dist_batch(self.ds.graph, self.ds.labels, batch,
                                    self.mcfg.num_layers, tcfg.fanout,
                                    seed=int(self.rng.randint(2**31)),
                                    valid=valid), None
        return build_dist_unsup_batch(
            self.ds.graph, self.ds.labels, self.pair_sampler, batch,
            self.mcfg.num_layers, tcfg.fanout, num_neg=tcfg.num_neg,
            seed=int(self.rng.randint(2**31)), target_valid=valid)

    def train_epoch(self) -> float:
        """One epoch; returns the mean step loss (the per-step losses are
        left in ``self.step_losses``)."""
        tcfg = self.tcfg
        order = self.rng.permutation(self.ds.train_nodes)
        per_step = self.world * tcfg.b_loc
        steps = max(1, len(order) // per_step)
        losses, pending = [], None
        t_ep = time.perf_counter()

        def producer():
            for si in range(steps):
                chunk = order[si * per_step:(si + 1) * per_step]
                yield self._build_step_batch(chunk, per_step)

        stream = prefetch(producer, depth=tcfg.prefetch_depth,
                          enabled=tcfg.prefetch_depth > 0)
        try:
            for si, (db, pairs) in enumerate(stream):
                if pending is not None:
                    losses.append(fetch_with_deadline(*pending))
                t = dist_batch_to_device(db, self.device, self.group)
                if pairs is None:
                    loss = self._run_step(self._step, self.params,
                                          self.feats_local, t)
                else:
                    loss = self._run_step(
                        self._unsup_step, self.params, self.feats_local, t,
                        pairs_to_device(pairs, self.device, self.group))
                pending = (loss, f"dist step {si + 1} loss fetch")
            losses.append(fetch_with_deadline(*pending))
        except BaseException:
            if isinstance(stream, Prefetcher):
                stream.close()
            raise
        self.step_losses = losses
        mean_loss = float(np.mean(losses))
        epoch_s = time.perf_counter() - t_ep
        edges = steps * edges_per_batch(per_step, self.mcfg.num_layers,
                                        tcfg.fanout)
        self.metrics.log("epoch", epoch=self.epoch, mean_loss=mean_loss,
                         steps=steps, nodes_per_step=per_step,
                         epoch_s=round(epoch_s, 3),
                         edges_per_sec=round(edges / epoch_s, 1),
                         n_dev=self.world)
        if tcfg.verbose:
            print(f"dist epoch {self.epoch}: mean loss {mean_loss:.4f} "
                  f"({steps} steps x {per_step} nodes)")
        return mean_loss

    # ----------------------------------------------------------------- eval
    def embed_nodes(self, nodes: np.ndarray) -> np.ndarray:
        """The distributed forward over arbitrary nodes (padded to a full
        grid); every rank gets every row."""
        per = self.world * self.tcfg.b_loc
        out = np.zeros((len(nodes), self.mcfg.out_size), np.float32)
        for lo in range(0, len(nodes), per):
            chunk = nodes[lo:lo + per]
            real = len(chunk)
            if real < per:
                chunk = np.resize(chunk, per)
            batch = np.asarray(chunk).reshape(self.world, self.tcfg.b_loc)
            db = build_dist_batch(self.ds.graph, self.ds.labels, batch,
                                  self.mcfg.num_layers, self.tcfg.fanout,
                                  seed=int(self.rng.randint(2**31)))
            t = dist_batch_to_device(db, self.device, self.group)
            embs = comm.all_gather_no_grad(
                self._fwd(self.params["sage"], self.feats_local, t),
                self.group)
            out[lo:lo + real] = fetch_with_deadline(
                embs, label="dist embedding fetch",
                convert=lambda x: x.float().numpy())[:real]
        return out

    def _predict(self, nodes: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            logp = classifier_apply(
                self.params["clf"],
                _to_device(self.embed_nodes(nodes), self.device))
        return logp.argmax(dim=1).cpu().numpy()

    def evaluate(self) -> float:
        val, test = self.ds.val_nodes, self.ds.test_nodes
        vali_f1 = micro_f1(self.ds.labels[val], self._predict(val))
        entry = {"epoch": self.epoch, "val_f1": vali_f1}
        self.metrics.log("eval", epoch=self.epoch, val_f1=vali_f1)
        if self.tcfg.verbose:
            print(f"Validation F1: {vali_f1:.4f}")
        if vali_f1 > self.max_vali_f1:
            self.max_vali_f1 = vali_f1
            entry["test_f1"] = micro_f1(self.ds.labels[test],
                                        self._predict(test))
            self.metrics.log("test", epoch=self.epoch,
                             test_f1=entry["test_f1"])
            if self.tcfg.verbose:
                print(f"Test F1: {entry['test_f1']:.4f}")
            if self.checkpoint_fn is not None:
                self.checkpoint_fn(self, entry["test_f1"])
        self.history.append(entry)
        return self.max_vali_f1

    def train_classification(self) -> float:
        """Classifier-only fit on frozen distributed embeddings (the
        reference's unsup protocol, src/utils.py:80-111), with an
        evaluation after every classifier epoch."""
        tcfg = self.tcfg
        embs = self.embed_nodes(np.arange(self.ds.num_nodes))
        train = np.asarray(self.ds.train_nodes)
        best = self.max_vali_f1
        for _ in range(tcfg.clf_epochs):
            order = self.rng.permutation(train)
            for lo in range(0, len(order), tcfg.clf_b_sz):
                nodes = order[lo:lo + tcfg.clf_b_sz]
                logp = classifier_apply(self.params["clf"],
                                        _to_device(embs[nodes], self.device))
                lab = _to_device(self.ds.labels[nodes].astype(np.int32),
                                 self.device)
                loss = supervised_nll(logp, lab, torch.ones(
                    len(nodes), device=self.device))
                apply_gradients(self.params, loss, ("clf",), tcfg.clf_lr,
                                tcfg.clip)
            best = self.evaluate()
        return best

    def fit(self) -> float:
        """The outer loop from ``self.epoch``, so a resumed trainer
        continues at the epoch after its checkpoint."""
        for epoch in range(self.epoch, self.tcfg.epochs):
            self.epoch = epoch
            maybe_inject_test_wedge(epoch)
            self.train_epoch()
            if self.tcfg.learn_method == "unsup":
                if (epoch + 1) % 2 == 0:
                    self.train_classification()
            else:
                self.evaluate()
        return self.max_vali_f1
