"""Where the dense train step's time goes: the port of the JAX system's
``tools/profile_dense.py``.

Times three programs, each over T = ``--steps`` batches of
``RandomState(0).randint(0, N, (T, B))`` on Cora's adjacency cut to
``--cap`` slots a row (``subsample(cap, RandomState(99))``; 0 keeps every
neighbour), with a 2 x 128 model:

- ``full_step``: ``train.dense.make_dense_sup_epoch`` (sampling, encode,
  loss, backward, clip and SGD a step);
- ``forward_only``: ``dense_forward`` a step, its sum;
- ``sampling_only``: ``sample_frontiers_dense`` a step, the sum of its
  bottom ids plus that of its first frontier's mask.

Each is timed as the JAX tool times its jitted scans: one warm call, then
one call with a synchronisation at its end, in ms a step.  Every call
starts from the same inputs: a fresh copy of the initial params (made
before the clock starts; ``full_step`` updates its copy in place) and a
generator on the card seeded 0 for the draws.  Params come from a
``torch.Generator`` seeded 0.

    python -m graphsage_torch.profile_dense [--cap 32] [--batch 512]
        [--steps 50] [--fanout 10] [--device cpu]

Prints one line a program.  Without a card it raises unless ``--device
cpu`` is given.  Cora is read from ``data/cora``
(``graphsage_torch.data.load_cora``); without it the loader raises
``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import setup_device
from graphsage_torch.data import load_cora
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.sampler.device import HopSampler, sample_frontiers_dense
from graphsage_torch.train.dense import dense_forward, make_dense_sup_epoch
from graphsage_torch.train.trainer import _leaf_params

PROGRAMS = ("full_step", "forward_only", "sampling_only")


def run(ds, cap: int = 32, batch: int = 512, steps: int = 50,
        fanout: int = 10, hidden: int = 128, device=None,
        params: dict | None = None, hop_for=None, keep: dict | None = None,
        log=print) -> dict:
    """ms a step of each program.  ``params`` overrides the seeded initial
    params, ``hop_for(program)`` the draws of each call (by default a
    HopSampler on a generator seeded 0); ``keep``, when given, receives
    each program's output of its timed call (and ``full_step``'s final
    params under ``"params"``)."""
    dev = setup_device(device)
    pad = ds.graph.to_padded()
    if cap:
        pad = pad.subsample(cap, np.random.RandomState(99))
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=hidden)
    if params is None:
        gen = torch.Generator().manual_seed(0)
        params = {"sage": init_graphsage(gen, mcfg),
                  "clf": init_classifier(gen, hidden, ds.num_classes)}
    feats = torch.from_numpy(np.ascontiguousarray(
        ds.features, dtype=np.float32)).to(dev)
    neighbors = torch.from_numpy(pad.neighbors).to(dev)
    degrees = torch.from_numpy(pad.degrees).to(dev)
    labels_all = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)

    def seeded(program: str) -> HopSampler:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return HopSampler(neighbors, degrees, gen)

    hop_for = hop_for or seeded
    rng = np.random.RandomState(0)
    t, b = steps, batch
    batches = torch.from_numpy(
        rng.randint(0, ds.num_nodes, (t, b)).astype(np.int32)).to(dev)
    labels = labels_all[batches.long()]
    epoch = make_dense_sup_epoch(mcfg, fanout=fanout)

    def full_step(p):
        return epoch(p, feats, hop_for("full_step"), batches, labels)

    def forward_only(p):
        hop = hop_for("forward_only")
        with torch.no_grad():
            return torch.stack([dense_forward(p, mcfg, feats, hop, batch,
                                              fanout).sum()
                                for batch in batches])

    def sampling_only(p):
        hop = hop_for("sampling_only")
        sums = []
        for batch in batches:
            x0_ids, fr = sample_frontiers_dense(hop, batch, 2, fanout)
            sums.append(x0_ids.sum() + fr[0].mask.sum())
        return torch.stack(sums)

    out = {}
    for name, fn in zip(PROGRAMS, (full_step, forward_only, sampling_only)):
        fn(_leaf_params(params, dev)).cpu()
        p = _leaf_params(params, dev)
        bench.sync(dev)
        t0 = time.perf_counter()
        res = fn(p).cpu()
        out[name] = (time.perf_counter() - t0) / t * 1000
        log(f"{name}: {out[name]:.3f} ms/step")
        if keep is not None:
            keep[name] = res
            if name == "full_step":
                keep["params"] = p
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = load_cora()
    run(ds, args.cap, args.batch, args.steps, args.fanout, device=dev,
        log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
