"""Quality validation for the leaf-cached pipeline: the port of the JAX
system's ``tools/validate_cached.py``.

Trains Cora supervised with the reference protocol's shape (50 epochs,
shuffled batches, SGD 0.7 + clip 5, best-val -> test micro-F1) entirely on
the cached pipeline (``train/cached.py``) and prints each epoch's F1.  The
bar: the compact trainer's F1 at these settings.

An epoch is the JAX tool's ``make_cached_sup_epoch``: one leaf-cache refresh
(``refresh_leaf_cache``), then ``CachedStep`` over the T rows of
``np.resize(permutation(train)[:T*B], (T, B))`` on that cache
(``cached_epoch_reuse``).  The shuffles and the ``--cap`` table draw come
from one ``RandomState(seed)``, the table first.  The device draws come
from a ``torch.Generator`` a program, seeded with the integer of the JAX
tool's PRNG key: ``seed*1000 + ep`` for epoch ep (its refresh, then its
steps), ``7000 + ep`` for the val embedding and ``9000 + ep`` for the test
embedding (each a fresh refresh, then the forward's hops).  Params come
from a ``torch.Generator`` seeded ``seed`` (the sage layers, then the
classifier).  Under ``--compute_dtype bfloat16`` the feature table and the
refresh stay float32; ``cached_forward`` rounds the params, the table and
the cache to bfloat16 (``train.dense.cast_compute``), as the JAX tool's
epoch does.

    python -m graphsage_torch.validate_cached [--dataSet cora] [--epochs 50]
        [--b_sz 512] [--compute_dtype bfloat16] [--cap N] [--device cpu]

Without a card it raises unless ``--device cpu`` is given.  Cora is read
from ``data/cora`` (``graphsage_torch.data.load_cora``); without it the
loader raises ``FileNotFoundError``.  ``--dataSet powerlaw:N:E`` trains on
a synthetic graph instead.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from graphsage_torch.bigscale_bench import setup_device
from graphsage_torch.data import load_dataset
from graphsage_torch.models import (GraphSageConfig, classifier_apply,
                                    init_classifier, init_graphsage)
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.cached import (CachedStep, cached_epoch_reuse,
                                          cached_forward, refresh_leaf_cache,
                                          sample_cached_frontiers)
from graphsage_torch.train.metrics import micro_f1
from graphsage_torch.train.trainer import _leaf_params

EPOCHS = 50


def init_params(ds, mcfg: GraphSageConfig, seed: int) -> dict:
    """The sage layers, then the classifier, from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    return {"sage": init_graphsage(gen, mcfg),
            "clf": init_classifier(gen, mcfg.out_size, ds.num_classes)}


def epoch_batches(train_nodes: np.ndarray, b: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """One epoch's [T, B] stack: the first T*B of a shuffle, T =
    max(1, len // B) (a split shorter than B repeats to fill one row)."""
    order = rng.permutation(train_nodes)
    t = max(1, len(order) // b)
    return np.resize(order[:t * b], (t, b)).astype(np.int32)


def seeded_hops(neighbors: torch.Tensor, degrees: torch.Tensor):
    """``hop_for(seed, kind)``: a HopSampler drawing from a generator on
    the tables' device seeded ``seed`` (``kind`` is "epoch" or "embed")."""
    def hop_for(seed: int, kind: str) -> HopSampler:
        gen = torch.Generator(device=neighbors.device)
        gen.manual_seed(seed)
        return HopSampler(neighbors, degrees, gen)
    return hop_for


def run(ds, epochs: int = EPOCHS, b_sz: int = 512, fanout: int = 10,
        hidden: int = 128, lr: float = 0.7,
        compute_dtype: str = "float32", seed: int = 824,
        cap: int | None = None, device=None, params: dict | None = None,
        hop_for=None, log=print) -> dict:
    """Train ``ds`` as the JAX tool does; returns the record: each epoch's
    mean step loss, val F1 and (where val improved) test F1, the best val
    F1 and the test F1 at it, the wall seconds, and the final params.
    ``params`` overrides the seeded initial params; ``hop_for(seed, kind)``
    the device draws (:func:`seeded_hops`)."""
    dev = setup_device(device)
    rng = np.random.RandomState(seed)
    pad = (ds.graph.to_padded() if cap is None
           else ds.graph.to_padded_sampled(cap, rng))
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=hidden, compute_dtype=compute_dtype)
    params = _leaf_params(params if params is not None
                          else init_params(ds, mcfg, seed), dev)
    feats = torch.from_numpy(np.ascontiguousarray(
        ds.features, dtype=np.float32)).to(dev)
    neighbors = torch.from_numpy(pad.neighbors).to(dev)
    degrees = torch.from_numpy(pad.degrees).to(dev)
    hop_for = hop_for or seeded_hops(neighbors, degrees)
    labels_all = ds.labels.astype(np.int32)
    step = CachedStep(mcfg, learn_method="sup", fanout=fanout, lr=lr)

    def embed(nodes: np.ndarray, hop) -> torch.Tensor:
        with torch.no_grad():
            cache = refresh_leaf_cache(hop, feats, fanout, mcfg.agg_func)
            ids, frontiers = sample_cached_frontiers(
                hop, torch.from_numpy(nodes.astype(np.int32)).to(dev), mcfg,
                fanout)
            return cached_forward(params, mcfg, feats, *cache, ids,
                                  frontiers, fanout)

    def predict(nodes: np.ndarray, hop) -> np.ndarray:
        with torch.no_grad():
            logp = classifier_apply(params["clf"], embed(nodes, hop))
        return logp.argmax(dim=1).cpu().numpy()

    history = []
    best_val, best_test = 0.0, float("nan")
    t_start = time.time()
    for ep in range(epochs):
        batches = epoch_batches(ds.train_nodes, b_sz, rng)
        labels = labels_all[batches]
        hop = hop_for(seed * 1000 + ep, "epoch")
        cache = refresh_leaf_cache(hop, feats, fanout, mcfg.agg_func)
        losses = cached_epoch_reuse(
            step, params, feats, *cache, hop,
            torch.from_numpy(batches).to(dev),
            torch.from_numpy(labels).to(dev))
        mean_loss = float(np.mean(losses.cpu().numpy()))
        val_f1 = micro_f1(labels_all[ds.val_nodes],
                          predict(ds.val_nodes, hop_for(7000 + ep, "embed")))
        entry = {"epoch": ep, "loss": mean_loss, "val_f1": val_f1}
        line = f"epoch {ep}: loss {mean_loss:.4f} val_f1 {val_f1:.4f}"
        if val_f1 > best_val:
            best_val = val_f1
            best_test = micro_f1(labels_all[ds.test_nodes], predict(
                ds.test_nodes, hop_for(9000 + ep, "embed")))
            entry["test_f1"] = best_test
            line += f" test_f1 {best_test:.4f}"
        history.append(entry)
        log(line)
    wall = time.time() - t_start
    log(f"BEST val {best_val:.4f} test {best_test:.4f} ({wall:.0f}s wall)")
    return {"epochs": history, "best_val_f1": best_val,
            "test_f1_at_best_val": best_test, "wall_s": wall,
            "params": params}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataSet", type=str, default="cora")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--b_sz", type=int, default=512)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.7)
    ap.add_argument("--compute_dtype", type=str, default="float32")
    ap.add_argument("--seed", type=int, default=824)
    ap.add_argument("--cap", type=int, default=None,
                    help="neighbor-table width cap (None = full degree)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = load_dataset(args.dataSet, seed=args.seed)
    run(ds, epochs=args.epochs, b_sz=args.b_sz, fanout=args.fanout,
        hidden=args.hidden, lr=args.lr, compute_dtype=args.compute_dtype,
        seed=args.seed, cap=args.cap, device=dev,
        log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
