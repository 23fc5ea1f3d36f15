"""Quality against leaf-cache staleness (``refresh_every`` k): the port of
the JAX system's ``tools/staleness_quality.py``.

Trains the cached supervised pipeline (``CachedTrainer`` with plain batches,
``extend_batches=False``) for k in (1, 2, 4, 8) on Cora (b_sz 512) and
Pubmed (b_sz 1024), 50 epochs, seed 824, fanout 10, 2 x 128, and records
each run's best val F1, the test F1 at it and the wall seconds: the quality
side of the staleness lever whose throughput ``bigscale_bench`` measures
(``staleness_edges_per_sec``).  k = 1 refreshes every epoch.

Writes ``STALENESS.json`` in the output directory: the JAX tool's keys
(``protocol``, ``backend``, one list of rows a dataset), ``backend`` the
card's name, and beside them the card's power limit.

    python -m graphsage_torch.staleness_quality [--out DIR] [--device cpu]

Without a card it raises unless ``--device cpu`` is given.  Cora and Pubmed
are read from ``data/cora`` and ``data/pubmed-data``
(``graphsage_torch.data``), both before the first run; a missing one raises
the loader's ``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import setup_device
from graphsage_torch.data import load_cora, load_pubmed
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import CachedTrainer, TrainConfig

KS = (1, 2, 4, 8)
EPOCHS = 50
# (name, b_sz), the JAX tool's
DATASETS = (("cora", 512), ("pubmed", 1024))
PROTOCOL = ("cached sup pipeline, {epochs} epochs, seed 824, plain batches "
            "(extend_batches=False), fanout 10, 2x128; k=1 is round-3 "
            "refresh-per-epoch semantics")
OUT_FILE = "STALENESS.json"


def run(ds, b_sz: int, k: int, epochs: int = EPOCHS, device=None,
        trainers: list | None = None) -> dict:
    """One row: the fit at refresh_every ``k`` (its trainer appended to
    ``trainers`` when given)."""
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=128)
    tcfg = TrainConfig(learn_method="sup", epochs=epochs, b_sz=b_sz,
                       seed=824, verbose=False, refresh_every=k)
    tr = CachedTrainer(ds, mcfg, tcfg, extend_batches=False,
                       device=setup_device(device))
    t0 = time.time()
    tr.fit()
    best = max((h for h in tr.history if "test_f1" in h),
               key=lambda h: h["val_f1"], default={})
    if trainers is not None:
        trainers.append(tr)
    return {"refresh_every": k, "best_val_f1": round(tr.max_vali_f1, 4),
            "test_f1_at_best_val": round(best.get("test_f1", float("nan")),
                                         4),
            "wall_s": round(time.time() - t0, 1)}


def study(datasets, ks=KS, epochs: int = EPOCHS, device=None,
          trainers: list | None = None, log=print) -> dict:
    """The record over ``datasets``, (name, Dataset, b_sz) triples."""
    dev = setup_device(device)
    backend, limit = bench.card(dev)
    out = {"protocol": PROTOCOL.format(epochs=epochs), "backend": backend,
           "power_limit": limit}
    for name, ds, b_sz in datasets:
        out[name] = [run(ds, b_sz, k, epochs, dev, trainers) for k in ks]
        log(f"# {name}: {json.dumps(out[name])}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=bench.DEFAULT_OUT,
                    help="directory of the output file")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    loaders = {"cora": load_cora, "pubmed": load_pubmed}
    datasets = [(name, loaders[name](), b_sz) for name, b_sz in DATASETS]
    out = study(datasets, device=dev,
                log=lambda line: print(line, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
