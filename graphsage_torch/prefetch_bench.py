"""The host/device overlap of compact training: the port of the JAX
system's ``tools/prefetch_bench.py``.

Times the compact ``Trainer``'s epoch with ``prefetch_depth`` 0 (the serial
path: each step's host batch, pair sampling and the C++ compact build, made
before the step) and 2 (the batches made on a bounded worker thread while
the card runs the previous step): one warm epoch, then ``--epochs`` timed
ones, the mean.  2 x 128, seed 824.  The dense and cached pipelines sample
on the card and have no host batch to hide.

The prefetch thread changes no arithmetic: ``run(..., keep=...)`` hands
back each depth's final params, and both depths end bit-equal (on the card
only under ``torch.use_deterministic_algorithms``: otherwise the float32
backward's ``index_add_`` adds in atomics' order).  The record holds the
JAX tool's keys, the card's name and its power limit.

    python -m graphsage_torch.prefetch_bench [--dataset cora] [--epochs 3]
        [--b_sz 128] [--learn_method sup] [--out FILE] [--device cpu]

The record is printed and, with ``--out``, written to that file.  Without a
card it raises unless ``--device cpu`` is given.  Cora and Pubmed are read
from ``data/`` (``graphsage_torch.data``); a missing one raises the loader's
``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import setup_device
from graphsage_torch.data import load_cora, load_pubmed
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import Trainer, TrainConfig
from graphsage_torch.train.optim import tree_leaves


def run(ds, dataset: str = "cora", epochs: int = 3, b_sz: int = 128,
        learn_method: str = "sup", device=None,
        keep: dict | None = None) -> dict:
    """The record on ``ds`` (``dataset`` names it).  ``keep``, when given,
    receives each depth's unrounded seconds an epoch (``epoch_s``) and
    final params (``params``)."""
    dev = setup_device(device)
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=128)
    seconds, params = {}, {}

    def timed(depth: int) -> float:
        tcfg = TrainConfig(learn_method=learn_method, b_sz=b_sz,
                           epochs=epochs, seed=824, verbose=False,
                           prefetch_depth=depth)
        tr = Trainer(ds, mcfg, tcfg, device=dev)
        tr.train_epoch()          # warm epoch: loads the kernels
        t0 = time.perf_counter()
        for _ in range(epochs):
            tr.train_epoch()
        seconds[depth] = (time.perf_counter() - t0) / epochs
        params[depth] = [p.detach() for p in tree_leaves(tr.params)]
        return seconds[depth]

    serial = timed(0)
    overlapped = timed(2)
    name, limit = bench.card(dev)
    if keep is not None:
        keep.update(epoch_s=seconds, params=params)
    return {
        "dataset": dataset, "b_sz": b_sz, "learn_method": learn_method,
        "epoch_s_serial": round(serial, 3),
        "epoch_s_prefetch2": round(overlapped, 3),
        "speedup": round(serial / overlapped, 3),
        "device": name, "power_limit": limit,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--b_sz", type=int, default=128)
    ap.add_argument("--learn_method", default="sup")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = {"cora": load_cora, "pubmed": load_pubmed}[args.dataset]()
    result = run(ds, args.dataset, args.epochs, args.b_sz,
                 args.learn_method, dev)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
