"""Compact training: sup / unsup / plus_unsup, with the reference's protocol.

Port of ``graphsage_tpu/train/trainer.py`` (the compact pipeline, the CLI's
default).  Per batch:

- the host extends the batch with walk-positive / negative pair endpoints
  (reference src/utils.py:149, for every learn method) and builds the
  sampled computation graph as fixed-shape frontier tables (C++ engine),
  on a prefetch thread while the card runs the previous step;
- the step runs eagerly on the device: feature-table transform, L-layer
  encode (MEAN through the ``gather_mean`` kernel with its scatter-add
  backward, MAX through ``gather_max`` with its tie-splitting backward,
  LSTM through ``gather_rows`` and the cell), classifier + NLL and/or the
  unsupervised loss
  (its score block the ``pair_scores`` kernel), ``backward``, per-model
  clip, SGD;
- evaluation embeds val/test with fresh sampling and scores micro-F1 with
  the best-val -> test protocol (src/utils.py:27-52).

Reference hyperparameters are the defaults: joint SGD lr 0.7, clip 5
(src/utils.py:136,185-186), classifier-only lr 0.5 / 800 epochs / b_sz 50
(src/utils.py:82-85), embedding batches of 500 (src/utils.py:63), num_neg
100 for 'normal' / 6 for 'margin' (src/utils.py:119-122).

Parameters are ``{"sage": {"layers": [{"weight"}]}, "clf": {"weight",
"bias"}}`` (with LSTM also ``"sage": {"agg": [cell, ...]}``) of float32 leaf
tensors, the JAX package's layout, so ``convert.params_from_jax`` carries a
JAX ``Trainer``'s params over unchanged.  The trainer runs on the card
unless ``device="cpu"`` is given; with no card and no device it raises.
MEAN, MAX and LSTM train (LSTM batches get their slots shuffled on the
host, as in the JAX package), in float32 or in bfloat16 with float32 master
params: the feature table is held in the compute dtype, and the step rounds
the params to it inside the loss (``train.dense.cast_compute``), as the
JAX package's step does.  Embeddings come back to the host as float32, and
the classifier-only fit and the predictions run in float32 on them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from graphsage_torch.convert import params_from_jax
from graphsage_torch.data.loaders import Dataset
from graphsage_torch.infer import _resolve_device
from graphsage_torch.losses import supervised_nll, unsup_loss_from_pairbatch
from graphsage_torch.models.graphsage import (Frontier, GraphSageConfig,
                                              _check_trainable, compute_dtype,
                                              graphsage_apply_gathered,
                                              init_graphsage)
from graphsage_torch.models.layers import classifier_apply, init_classifier
from graphsage_torch.sampler import PairSampler, build_compact_batch
from graphsage_torch.sampler.compact import _bucket
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.metrics import micro_f1
from graphsage_torch.train.optim import apply_gradients
from graphsage_torch.utils.obs import (MetricsLogger, collective_watchdog,
                                       fetch_with_deadline,
                                       maybe_inject_test_wedge)
from graphsage_torch.utils.prefetch import Prefetcher, prefetch


@dataclasses.dataclass
class TrainConfig:
    learn_method: str = "sup"        # sup | unsup | plus_unsup
    unsup_loss: str = "normal"       # normal | margin
    b_sz: int = 20
    epochs: int = 50
    lr: float = 0.7
    clf_lr: float = 0.5
    clip_norm: float = 5.0
    fanout: int = 10
    seed: int = 824
    clf_epochs: int = 800
    clf_b_sz: int = 50
    emb_b_sz: int = 500
    # True (the reference's protocol, src/utils.py:110 -> :27) re-embeds
    # val/test with fresh sampling on every classifier epoch; False scores
    # the classifier on the cached embeddings (not protocol-identical)
    strict_clf_eval: bool = True
    verbose: bool = True
    metrics_path: str | None = None   # jsonl metrics sink (utils/obs.py)
    # build batch i+1 on a worker thread while the card runs step i; depth
    # bounds the run-ahead, 0 builds serially.  Bit-identical either way
    prefetch_depth: int = 2
    # cached pipeline only: refresh the leaf cache every k epochs instead
    # of every epoch (k=1, the default)
    refresh_every: int = 1

    @property
    def num_neg(self) -> int:
        if self.unsup_loss == "margin":
            return 6
        if self.unsup_loss == "normal":
            return 100
        raise ValueError("unsup_loss can be only 'margin' or 'normal'.")


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _frontiers(cb, device: torch.device) -> list[Frontier]:
    return [Frontier(idx=_to_device(f.idx, device),
                     mask=_to_device(f.mask, device),
                     self_idx=_to_device(f.self_idx, device))
            for f in cb.frontiers]


def _pair_tensors(pb, device: torch.device) -> dict:
    # target_rows routes the losses through the score block (ops/sddmm.py)
    return {name: _to_device(getattr(pb, name), device)
            for name in ("pos_q", "pos_mask", "neg_q", "neg_mask",
                         "node_valid", "target_rows")}


def _leaf_params(tree, device: torch.device):
    """A param pytree as float32 leaf tensors on ``device`` that require
    grad (copies: the caller's arrays are never updated in place)."""
    tree = params_from_jax(tree, device)

    def leaf(node):
        if isinstance(node, dict):
            return {k: leaf(v) for k, v in node.items()}
        if isinstance(node, list):
            return [leaf(v) for v in node]
        return node.detach().float().clone().requires_grad_(True)

    return leaf(tree)


class Trainer:
    def __init__(self, dataset: Dataset, model_cfg: GraphSageConfig,
                 train_cfg: TrainConfig,
                 checkpoint_fn: Callable | None = None,
                 params: dict | None = None,
                 device: str | torch.device | None = None):
        """``params``: the initial {"sage", "clf"} pytree (numpy arrays or
        tensors, e.g. a JAX ``Trainer``'s); by default drawn from a
        ``torch.Generator`` seeded with ``train_cfg.seed``."""
        self._check_config(model_cfg)
        self.ds = dataset
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.checkpoint_fn = checkpoint_fn
        self.device = _resolve_device(device)

        if params is None:
            gen = torch.Generator().manual_seed(train_cfg.seed)
            params = {"sage": init_graphsage(gen, model_cfg),
                      "clf": init_classifier(gen, model_cfg.out_size,
                                             dataset.num_classes)}
        self.params = _leaf_params(params, self.device)
        # the constant feature table in the compute dtype: in bfloat16 every
        # gather moves half the bytes, and the aggregates sum in float32
        self.feats = _to_device(dataset.features.astype(np.float32),
                                self.device).to(compute_dtype(model_cfg))
        self.labels_np = np.asarray(dataset.labels)
        self.rng = np.random.RandomState(train_cfg.seed)
        self.pair_sampler = PairSampler(dataset.graph, dataset.train_nodes)
        # build the exact negatives' far lists in the background, while
        # the first steps run (bit-identical to building them lazily)
        self.pair_sampler.prewarm_async(dataset.train_nodes)
        self.max_vali_f1 = 0.0
        self.epoch = 0
        self.history: list[dict] = []
        self.step_losses: list[float] = []   # the last epoch's, per step
        self.metrics = MetricsLogger(train_cfg.metrics_path)
        self._warmed = False   # the first step runs under a watchdog

    @staticmethod
    def _check_config(model_cfg: GraphSageConfig) -> None:
        """The compact pipeline trains MEAN, MAX and LSTM in float32 or
        bfloat16."""
        _check_trainable(model_cfg)
        compute_dtype(model_cfg)

    # ---------------------------------------------------------------- step
    def _encode(self, sage_params: dict, x0_ids: torch.Tensor,
                frontiers: list[Frontier]) -> torch.Tensor:
        """The encoder on one compact batch on the device, in the compute
        dtype; the params are rounded to it here, inside the differentiated
        function, so that the float32 masters get float32 gradients."""
        return graphsage_apply_gathered(
            cast_compute(sage_params, self.mcfg), self.mcfg, self.feats,
            x0_ids, frontiers)

    def _step(self, pb, cb, labels: np.ndarray,
              row_mask: np.ndarray) -> torch.Tensor:
        """One joint step: encode, loss, backward, per-model clip, SGD.
        Returns the loss (a device scalar, not synchronised).

        The whole batch goes to the device before the step launches
        anything.  A copy from ordinary host memory waits for all the
        work queued on the device, outside any deadline; made first, the
        copies wait only for the steps before, whose loss ``train_epoch``
        has already waited for under the deadline."""
        tcfg = self.tcfg
        dev = self.device
        x0_ids, frontiers = _to_device(cb.x0_ids, dev), _frontiers(cb, dev)
        sup = tcfg.learn_method in ("sup", "plus_unsup")
        unsup = tcfg.learn_method in ("unsup", "plus_unsup")
        if sup:
            labels = _to_device(labels, dev)
            row_mask = _to_device(row_mask, dev)
        if unsup:
            pairs = _pair_tensors(pb, dev)
        embs = self._encode(self.params["sage"], x0_ids, frontiers)
        loss = torch.zeros((), device=dev)
        if sup:
            logp = classifier_apply(cast_compute(self.params["clf"],
                                                 self.mcfg), embs)
            loss = loss + supervised_nll(logp, labels, row_mask)
        if unsup:
            loss = loss + unsup_loss_from_pairbatch(
                embs, pairs, tcfg.unsup_loss,
                q=self.pair_sampler.q, margin=self.pair_sampler.margin)
        apply_gradients(self.params, loss, ("sage", "clf"), tcfg.lr,
                        tcfg.clip_norm)
        return loss.detach()

    # ----------------------------------------------------------- embedding
    def embed_nodes(self, nodes: np.ndarray, sage_params=None) -> np.ndarray:
        """Encoder forward for arbitrary nodes with fresh sampling
        (reference graphSage(nodes) call sites); [len(nodes), H] f32."""
        sage_params = sage_params or self.params["sage"]
        nodes = np.asarray(nodes)
        padded = np.zeros(_bucket(len(nodes)), dtype=np.int64)
        padded[:len(nodes)] = nodes
        cb = build_compact_batch(self.ds.graph, padded, self.rng,
                                 num_layers=self.mcfg.num_layers,
                                 fanout=self.tcfg.fanout, gcn=self.mcfg.gcn,
                                 shuffle_slots=self.mcfg.agg_func == "LSTM")
        with torch.no_grad():
            embs = self._encode(sage_params,
                                _to_device(cb.x0_ids, self.device),
                                _frontiers(cb, self.device))
        return embs.float().cpu().numpy()[:len(nodes)]

    def all_embeddings(self) -> np.ndarray:
        """Embeddings of every node, in batches of ``emb_b_sz`` (reference
        get_gnn_embeddings, src/utils.py:59-78)."""
        n = self.ds.num_nodes
        b = self.tcfg.emb_b_sz
        out = np.zeros((n, self.mcfg.out_size), dtype=np.float32)
        for lo in range(0, n, b):
            nodes = np.arange(lo, min(lo + b, n))
            out[nodes] = self.embed_nodes(nodes)
        return out

    # ---------------------------------------------------------------- eval
    def _predict(self, nodes: np.ndarray, embs: np.ndarray | None = None
                 ) -> np.ndarray:
        if embs is None:
            embs = self.embed_nodes(nodes)
        with torch.no_grad():
            logp = classifier_apply(self.params["clf"],
                                    _to_device(embs, self.device))
        return logp.argmax(dim=1).cpu().numpy()

    def evaluate(self, cached_embs: np.ndarray | None = None) -> float:
        """Best-val -> test protocol (reference src/utils.py:13-57): val
        micro-F1; on improvement, test micro-F1 and ``checkpoint_fn``."""
        val, test = self.ds.val_nodes, self.ds.test_nodes
        pred = self._predict(val, None if cached_embs is None
                             else cached_embs[val])
        vali_f1 = micro_f1(self.labels_np[val], pred)
        if self.tcfg.verbose:
            print(f"Validation F1: {vali_f1:.4f}")
        entry = {"epoch": self.epoch, "val_f1": vali_f1}
        self.metrics.log("eval", epoch=self.epoch, val_f1=vali_f1)
        if vali_f1 > self.max_vali_f1:
            self.max_vali_f1 = vali_f1
            pred_t = self._predict(test, None if cached_embs is None
                                   else cached_embs[test])
            test_f1 = micro_f1(self.labels_np[test], pred_t)
            entry["test_f1"] = test_f1
            self.metrics.log("test", epoch=self.epoch, test_f1=test_f1)
            if self.tcfg.verbose:
                print(f"Test F1: {test_f1:.4f}")
            if self.checkpoint_fn is not None:
                self.checkpoint_fn(self, test_f1)
        self.history.append(entry)
        return self.max_vali_f1

    # --------------------------------------------------------------- train
    def _build_train_batch(self, nodes: np.ndarray):
        """Host-side (numpy-only) batch of one step: batch extension
        (reference src/utils.py:147-149, every learn method), compact
        frontiers, labels and row mask.  Runs on the prefetch thread and
        consumes self.rng in order (see utils/prefetch.py)."""
        tcfg = self.tcfg
        pb = self.pair_sampler.sample_batch(nodes, tcfg.num_neg, self.rng)
        cb = build_compact_batch(
            self.ds.graph, pb.unique_nodes, self.rng,
            num_layers=self.mcfg.num_layers, fanout=tcfg.fanout,
            gcn=self.mcfg.gcn, shuffle_slots=self.mcfg.agg_func == "LSTM")
        u_pad = cb.out_rows
        labels = np.zeros(u_pad, dtype=np.int32)
        real = pb.unique_nodes[:pb.num_unique]
        labels[:pb.num_unique] = self.labels_np[real]
        row_mask = (np.arange(u_pad) < pb.num_unique).astype(np.float32)
        return pb, cb, labels, row_mask

    def train_epoch(self) -> float:
        """One joint epoch over the train split (reference apply_model,
        src/utils.py:113-193).  Returns the mean step loss; the per-step
        losses are left in ``self.step_losses``.

        Each step's loss is fetched through ``fetch_with_deadline``: in
        verbose mode right after the step, to print it (as the reference
        prints), in quiet mode just before the next step's copies to the
        device, which would wait for it anyway (see ``_step``), and the
        last one at the epoch's end.  A kernel that hangs in a step thus
        raises ``FetchDeadlineError`` at the fetch of that step's loss,
        and the host never blocks unguarded behind it."""
        tcfg = self.tcfg
        train_nodes = self.rng.permutation(self.ds.train_nodes)
        batches = math.ceil(len(train_nodes) / tcfg.b_sz)
        visited: set[int] = set()
        losses: list[float] = []
        pending = None   # (loss, label) of a step not fetched yet

        def producer():
            for bi in range(batches):
                nodes = train_nodes[bi * tcfg.b_sz:(bi + 1) * tcfg.b_sz]
                yield self._build_train_batch(nodes)

        stream = prefetch(producer, depth=tcfg.prefetch_depth,
                          enabled=tcfg.prefetch_depth > 0)
        try:
            for bi, batch in enumerate(stream):
                pb = batch[0]
                visited.update(int(v)
                               for v in pb.unique_nodes[:pb.num_unique])
                if pending is not None:
                    losses.append(fetch_with_deadline(*pending))
                    pending = None
                if self._warmed:
                    pending = (self._step(*batch),
                               f"step {bi + 1} loss fetch")
                else:
                    # the first step loads the kernels on the card (and
                    # builds them when no build is current): say it is
                    # warmup if it takes long
                    with collective_watchdog(
                            label="first train step (kernel load/warmup)"):
                        losses.append(fetch_with_deadline(
                            self._step(*batch),
                            label="step 1 loss fetch (warmup)"))
                    self._warmed = True
                if tcfg.verbose:
                    if pending is not None:
                        losses.append(fetch_with_deadline(*pending))
                        pending = None
                    # per-step loss print (reference src/utils.py:183)
                    print(f"Step [{bi + 1}/{batches}], Loss: "
                          f"{losses[-1]:.4f}, Dealed Nodes [{len(visited)}/"
                          f"{len(train_nodes)}]")
            if pending is not None:
                losses.append(fetch_with_deadline(*pending))
        except BaseException:
            if isinstance(stream, Prefetcher):
                stream.close()  # unblock and join the producer thread
            raise
        self.step_losses = losses
        mean_loss = float(np.mean(losses))
        self.metrics.log("epoch", epoch=self.epoch, mean_loss=mean_loss,
                         visited_nodes=len(visited),
                         train_nodes=len(train_nodes))
        return mean_loss

    def train_classification(self) -> float:
        """Classifier-only fit on frozen embeddings (reference
        src/utils.py:80-111): one embedding pass, then clf_epochs x batches
        of SGD(clf_lr), with an evaluation per epoch."""
        tcfg = self.tcfg
        feats = self.all_embeddings()
        train_nodes = np.asarray(self.ds.train_nodes)
        b = tcfg.clf_b_sz
        for _ in range(tcfg.clf_epochs):
            order = self.rng.permutation(train_nodes)
            for lo in range(0, len(order), b):
                nodes = order[lo:lo + b]
                pad = _bucket(len(nodes), minimum=b)
                emb_b = np.zeros((pad, feats.shape[1]), np.float32)
                lab_b = np.zeros(pad, np.int32)
                emb_b[:len(nodes)] = feats[nodes]
                lab_b[:len(nodes)] = self.labels_np[nodes]
                mask = (np.arange(pad) < len(nodes)).astype(np.float32)
                logp = classifier_apply(self.params["clf"],
                                        _to_device(emb_b, self.device))
                loss = supervised_nll(logp, _to_device(lab_b, self.device),
                                      _to_device(mask, self.device))
                apply_gradients(self.params, loss, ("clf",), tcfg.clf_lr,
                                tcfg.clip_norm)
            self.evaluate(cached_embs=None if tcfg.strict_clf_eval
                          else feats)
        return self.max_vali_f1

    def fit(self) -> float:
        """The outer loop (reference src/main.py:70-76), from
        ``self.epoch``: a resumed trainer continues at the epoch after its
        checkpoint."""
        tcfg = self.tcfg
        for epoch in range(self.epoch, tcfg.epochs):
            self.epoch = epoch
            maybe_inject_test_wedge(epoch)
            if tcfg.verbose:
                print(f"----------------------EPOCH {epoch}"
                      "-----------------------")
            t0 = time.time()
            mean_loss = self.train_epoch()
            if tcfg.verbose:
                print(f"epoch {epoch}: mean loss {mean_loss:.4f} "
                      f"({time.time() - t0:.1f}s)")
            if tcfg.learn_method == "unsup":
                if (epoch + 1) % 2 == 0:
                    self.train_classification()
            else:
                self.evaluate()
        return self.max_vali_f1
