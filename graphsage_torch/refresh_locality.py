"""Does the BFS relabeling speed the 1M-node refresh on the card?  The port
of the JAX system's ``tools/refresh_locality.py``.

The refresh aggregates a fresh fanout-10 subset of every node's row of the
[N, 602] bfloat16 feature table: 10M random 1,204-byte row reads.  If its
rate depends on locality, relabeling the graph in BFS order
(``parallel.partition.bfs_reorder`` + ``relabel_dataset``, which the
distributed pipeline already uses), which puts each node's neighbours at
nearby ids, should speed it.  This times the same refresh (a warm call,
then the median of 3, each synchronised on a scalar that reads the whole
output) over config 5's graph under the raw labeling and under the BFS
relabeling, with a fresh ``to_padded_sampled(32, RandomState(99))`` and
the same device-drawn features; the relabeling is a graph isomorphism, so
the work is the same.  Records the host time of the relabeling and the
speedup, in ``REFRESH_LOCALITY.json`` in the output directory.

    python -m graphsage_torch.refresh_locality [--out DIR]

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import (FANOUT, WIDTH, common_args,
                                            device_feats, load_1m,
                                            setup_device)
from graphsage_torch.parallel.partition import bfs_reorder, relabel_dataset
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import cached

OUT_FILE = "REFRESH_LOCALITY.json"
HOP_SEED = 824


def time_refresh(feats, neighbors, degrees, dev: torch.device,
                 fanout: int = FANOUT, reps: int = 3):
    """(median ms, [ms of each rep]) of the refresh over ``neighbors`` /
    ``degrees``, a hop sampler seeded HOP_SEED.  Each call ends in a fetch
    of a float32 sum over the cache and its counts, so the time covers the
    whole output."""
    hop = HopSampler(neighbors, degrees,
                     torch.Generator(device=dev).manual_seed(HOP_SEED))

    def probe():
        cf, cc = cached.refresh_leaf_cache(hop, feats, fanout)
        return float(torch.sum(cf, dtype=torch.float32) + cc.sum())

    probe()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def relabeled(ds):
    """(the dataset in BFS order, its width-32 sampled table, host s)."""
    t0 = time.time()
    ds2 = relabel_dataset(ds, bfs_reorder(ds.graph))
    pad2 = ds2.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    return ds2, pad2, time.time() - t0


def _on(pad, dev):
    return (torch.from_numpy(pad.neighbors).to(dev),
            torch.from_numpy(pad.degrees).to(dev))


def run(ds, pad, feats, dev: torch.device, log=print) -> dict:
    raw_ms, raw_reps = time_refresh(feats, *_on(pad, dev), dev)
    log(f"# raw labeling: {raw_ms:.6f} ms {raw_reps}")
    _, pad2, reorder_s = relabeled(ds)
    log(f"# bfs_reorder + relabel + table: {reorder_s:.1f} s")
    bfs_ms, bfs_reps = time_refresh(feats, *_on(pad2, dev), dev)
    log(f"# bfs labeling: {bfs_ms:.6f} ms {bfs_reps}")
    device, power_limit = bench.card(dev)
    return {"workload": "1m", "mode": "refresh_locality",
            "raw_refresh_ms": raw_ms, "bfs_refresh_ms": bfs_ms,
            "speedup": raw_ms / bfs_ms,
            "raw_reps_ms": raw_reps, "bfs_reps_ms": bfs_reps,
            "host_reorder_s": reorder_s,
            "device": device, "power_limit": power_limit,
            "note": ("the same refresh, the graph relabeled in BFS order; "
                     "the difference is the locality of the wide-row "
                     "gather")}


def main(argv=None) -> int:
    args = common_args(__doc__.split("\n\n")[0]).parse_args(argv)
    dev = setup_device(args.device)
    ds, pad, gen_s = load_1m(args.nodes, args.edges)
    print(f"# graph {gen_s:.1f} s", file=sys.stderr, flush=True)
    feats = device_feats(ds.num_nodes, ds.feature_dim, dev)
    row = run(ds, pad, feats, dev,
              log=lambda *a: print(*a, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump({"rows": [row]}, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps([row]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
