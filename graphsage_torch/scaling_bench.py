"""Edges/s and weak-scaling efficiency of the distributed pipelines: the port
of the JAX system's ``tools/scaling_bench.py``.

BASELINE.json config 5's pipelines on a synthetic power-law graph (100,000
nodes, 1,000,000 edges, 602 features, hidden 128, fanout 10, b_loc 256 a
rank), float32, for each world size of ``--devices``:

- ``--pipeline halo``: edge-partitioned features (``shard_features``) and
  the all_to_all halo exchange (``make_dist_sup_step``, lr 0.1); two warm
  batches (seeds 0, 1), then ``--steps`` batches prebuilt on the host
  (seeds 100 + i, so host time is excluded), one synchronisation after the
  timed loop;
- ``--pipeline cached``: the sharded leaf-cached epoch (the row-sharded
  layer-1 table: ``local_refresh``, then ``cached_epoch_reuse`` over a
  ``CachedDistStep``, lr 0.1) on ``min(steps, T)`` steps of one
  ``build_epoch_stack``; one warm epoch, then 3 timed epochs.

As in the JAX tool, both models are initialised from the same seed (0),
and ONE ``RandomState(0)`` feeds every world in turn: the parent draws
every batch in the JAX tool's order and hands each world its arrays.

World 1 runs in this process: over NCCL on the card, over gloo with
``--device cpu``.  On the card only world 1 runs, whatever the card count:
a larger world would need one process a card, so the module logs the
worlds it skips (the JAX tool stops at the first world above its device
count).  With ``--device cpu`` the larger worlds run as gloo ranks on the
CPU, one process each (``parallel/ranks.py``), and the rates are relative
only.  Beside the JAX
tool's keys each result records the kernel launches of its timed part,
and the record the card's name and power limit.  Writes
``SCALING_<pipeline>.json`` in the output directory.

    python -m graphsage_torch.scaling_bench [--pipeline halo|cached] \
        [--devices 1,2,4,8] [--out DIR]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import common_args, setup_device
from graphsage_torch.convert import params_to_numpy
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.parallel import multihost
from graphsage_torch.parallel.halo import shard_features
from graphsage_torch.parallel.ranks import run_ranks
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.cached import cached_epoch_reuse
from graphsage_torch.train.cached_dist import (CachedDistStep,
                                               build_epoch_stack,
                                               local_refresh, local_rows,
                                               pad_node_tables, rank_seed)
from graphsage_torch.train.dense import edges_per_batch
from graphsage_torch.train.distributed import (build_dist_batch,
                                               dist_batch_to_device,
                                               make_dist_sup_step)
from graphsage_torch.train.trainer import _leaf_params

LR, CACHED_REPS, TABLE_WIDTH = 0.1, 3, 32


def init_params(mcfg: GraphSageConfig, num_classes: int) -> dict:
    """Both models from generators seeded 0 (the JAX tool inits both from
    ``PRNGKey(0)``), as numpy arrays."""
    return params_to_numpy({
        "sage": init_graphsage(torch.Generator().manual_seed(0), mcfg),
        "clf": init_classifier(torch.Generator().manual_seed(0),
                               mcfg.out_size, num_classes)})


def halo_payloads(ds, worlds, b_loc: int, fanout: int, steps: int,
                  rng: np.random.RandomState):
    """Each world's halo batches, drawn from the shared ``rng`` in the JAX
    tool's order: two warm batches, then ``steps`` timed ones."""
    for n_dev in worlds:
        def make_batch(it):
            b = ds.train_nodes[rng.choice(len(ds.train_nodes),
                                          (n_dev, b_loc))]
            return build_dist_batch(ds.graph, ds.labels, b, 2, fanout,
                                    seed=it, cap=None)

        warm = [make_batch(it) for it in range(2)]
        timed = [make_batch(100 + it) for it in range(steps)]
        yield n_dev, {"warm": warm, "timed": timed,
                      "feats": shard_features(ds.features, n_dev)}


def cached_payloads(ds, worlds, b_loc: int, steps: int,
                    rng: np.random.RandomState):
    """Each world's padded tables and epoch stack (``min(steps, T)`` steps),
    the stack drawn from the shared ``rng``."""
    pad = ds.graph.to_padded_sampled(TABLE_WIDTH, np.random.RandomState(0))
    for n_dev in worlds:
        feats, neighbors, degrees = pad_node_tables(
            ds.features, pad.neighbors, pad.degrees, n_dev)
        batches, labs, masks = build_epoch_stack(
            ds.train_nodes, ds.labels, n_dev, n_dev * b_loc, rng)
        t_steps = min(steps, batches.shape[0])
        yield n_dev, {"feats": feats, "neighbors": neighbors,
                      "degrees": degrees,
                      "stack": (batches[:t_steps], labs[:t_steps],
                                masks[:t_steps])}


def halo_world(payload: dict, rank: int, world: int,
               dev: torch.device) -> dict:
    """One rank's halo run: the warm steps, then the timed ones; (s a step,
    the timed steps' launches, the last loss, the params after)."""
    mcfg = GraphSageConfig(**payload["cfg"])
    params = _leaf_params(payload["params"], dev)
    rows_per = payload["feats"].shape[0] // world
    feats = torch.from_numpy(np.ascontiguousarray(payload["feats"][
        rank * rows_per:(rank + 1) * rows_per])).to(dev)
    step = make_dist_sup_step(mcfg, lr=LR)
    for db in payload["warm"]:
        loss = step(params, feats, dist_batch_to_device(db, dev))
    float(loss)
    batches = [dist_batch_to_device(db, dev) for db in payload["timed"]]
    bench.sync(dev)
    agg.reset_launches()
    t0 = time.perf_counter()
    for t in batches:
        loss = step(params, feats, t)
    bench.sync(dev)
    dt = (time.perf_counter() - t0) / len(batches)
    return {"dt": dt, "launches": dict(agg.LAUNCHES), "loss": float(loss),
            "params": params_to_numpy(params)}


def cached_epoch(step: CachedDistStep, params: dict, feats, x_local, hop,
                 stack, fanout: int, rank: int, world: int) -> torch.Tensor:
    """One call of the JAX tool's ``make_cached_dist_epoch``: the rank's
    refresh from ``hop``, then the steps of its rows of ``stack``; the
    step losses."""
    cache = local_refresh(hop, feats, fanout, "MEAN", rank, world)
    return cached_epoch_reuse(step, params, x_local, *cache, hop, *stack)


def cached_world(payload: dict, rank: int, world: int,
                 dev: torch.device) -> dict:
    """One rank's cached run: a warm epoch (sampler seed 0), then
    CACHED_REPS timed epochs (seeds 1, 2, 3; rank r's stream
    ``rank_seed(seed, r)``)."""
    mcfg = GraphSageConfig(**payload["cfg"])
    fanout = payload["fanout"]
    params = _leaf_params(payload["params"], dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    feats = t(payload["feats"])
    hop = HopSampler(t(payload["neighbors"]), t(payload["degrees"]),
                     torch.Generator(device=dev))
    stack = [t(a[:, rank]) for a in payload["stack"]]
    step = CachedDistStep(mcfg, fanout=fanout, lr=LR)
    x_local = local_rows(feats, rank, world)

    def epoch(seed):
        hop.generator.manual_seed(rank_seed(seed, rank))
        return cached_epoch(step, params, feats, x_local, hop, stack,
                            fanout, rank, world)

    float(epoch(0)[-1])
    bench.sync(dev)
    agg.reset_launches()
    t0 = time.perf_counter()
    for r in range(CACHED_REPS):
        losses = epoch(r + 1)
    bench.sync(dev)
    dt = (time.perf_counter() - t0) / (CACHED_REPS * stack[0].shape[0])
    return {"dt": dt, "launches": dict(agg.LAUNCHES),
            "loss": float(losses[-1]), "params": params_to_numpy(params)}


def rank_main(payload: dict, rank: int, world: int) -> dict:
    """A gloo rank's body (``parallel/ranks.py``)."""
    run = cached_world if payload["pipeline"] == "cached" else halo_world
    return run(payload, rank, world, torch.device("cpu"))


def worlds_to_run(devices, dev: torch.device, log=print) -> list:
    """The worlds of ``devices`` that run on ``dev``: all on the CPU; on the
    card those of size 1 (one line logs the others)."""
    worlds = list(devices)
    if dev.type == "cpu":
        return worlds
    skipped = [n for n in worlds if n > 1]
    if skipped:
        log(f"worlds {skipped} skipped: on the card only world 1 runs (a "
            f"larger world needs one process a card; --device cpu runs "
            f"them as gloo ranks)")
    return [n for n in worlds if n == 1]


def run_world(payload: dict, n_dev: int, dev: torch.device) -> dict:
    """Rank 0's result of one world: world 1 in this process (over NCCL on
    the card, gloo on the CPU), larger worlds as ``n_dev`` gloo ranks on
    the CPU."""
    if n_dev > 1:
        return run_ranks("graphsage_torch.scaling_bench:rank_main", payload,
                         n_dev)[0]
    owned = not torch.distributed.is_initialized()
    dev = multihost.initialize(dev)
    try:
        run = cached_world if payload["pipeline"] == "cached" else halo_world
        return run(payload, 0, 1, dev)
    finally:
        if owned:
            multihost.shutdown()


def run(ds, dev: torch.device, pipeline: str = "halo", hidden: int = 128,
        b_loc: int = 256, fanout: int = 10, steps: int = 10,
        devices=(1, 2, 4, 8), edges: int | None = None,
        log=print) -> dict:
    """The record of ``pipeline`` over the worlds of ``devices`` that run on
    ``dev`` (:func:`worlds_to_run`; ``edges``: the edge count the graph was
    drawn with, for the workload key)."""
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=hidden)
    params = init_params(mcfg, ds.num_classes)
    worlds = worlds_to_run(devices, dev, log)
    rng = np.random.RandomState(0)
    payloads = (cached_payloads(ds, worlds, b_loc, steps, rng)
                if pipeline == "cached"
                else halo_payloads(ds, worlds, b_loc, fanout, steps, rng))
    results = []
    for n_dev, payload in payloads:
        payload.update(pipeline=pipeline, params=params, fanout=fanout,
                       cfg={"num_layers": 2, "input_size": ds.feature_dim,
                            "out_size": hidden})
        res = run_world(payload, n_dev, dev)
        dt = res["dt"]
        n_edges = edges_per_batch(b_loc, 2, fanout) * n_dev
        eps = n_edges / dt
        results.append({"devices": n_dev, "edges_per_sec": round(eps),
                        "step_ms": round(dt * 1000, 2)})
        base = results[0]["edges_per_sec"] * n_dev
        results[-1]["scaling_efficiency"] = round(
            eps / base if base else 0, 3)
        results[-1]["launches"] = res["launches"]
        log(json.dumps(results[-1]))
    device, power_limit = bench.card(dev)
    return {
        "pipeline": pipeline,
        "workload": {"nodes": ds.num_nodes, "edges": edges,
                     "feat_dim": ds.feature_dim, "hidden": hidden,
                     "b_loc": b_loc, "fanout": fanout, "steps": steps},
        "backend": dev.type,
        "note": ("gloo ranks on the CPU, one process each: relative "
                 "weak-scaling only; absolute rates are not the card's"
                 if dev.type == "cpu" else
                 "real device group (NCCL, one process a card)"),
        "results": results,
        "device": device, "power_limit": power_limit,
    }


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.set_defaults(nodes=100_000, edges=1_000_000)
    ap.add_argument("--feat_dim", type=int, default=602)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--b_loc", type=int, default=256,
                    help="batch per rank (weak scaling)")
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    ap.add_argument("--pipeline", type=str, default="halo",
                    choices=["halo", "cached"],
                    help="halo = edge-partitioned features + all_to_all "
                         "exchange; cached = sharded leaf-cached epoch "
                         "(row-sharded layer-1 table, all_gather fwd / "
                         "reduce-scatter bwd)")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = synthetic_power_law(args.nodes, args.edges,
                             num_feats=args.feat_dim, seed=0)
    record = run(ds, dev, args.pipeline, args.hidden, args.b_loc,
                 args.fanout, args.steps,
                 [int(x) for x in args.devices.split(",")], args.edges)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"SCALING_{args.pipeline}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
