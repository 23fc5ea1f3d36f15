"""The halo pipeline's fixed cost, and its weak scaling over gloo ranks: the
port of the JAX system's ``tools/halo_overhead.py``.

Two modes:

``chip`` (the default; on the card): the distributed supervised step
(``train.distributed.make_dist_sup_step``, lr 0.7, clip 5) at world 1
over NCCL, against a local program built from the SAME host-sampled
frontiers (``DistBatch.x0_ids``, the replay construction of the parity
tests): the layer-0 rows by one ``gather_rows`` of the feature table, the
encode, the classifier, the loss, one backward, a clip per model and SGD.
At world 1 the halo plan is all-local, so the difference is the cost of
the exchange machinery (the two all_to_alls, the request tables, the
address translation) before any scaling benefit.  The 100,000-node graph,
602 features, b_loc 4096, bfloat16, hidden 128, fanout 10.  The dist step
sends W1's transform of the rows ([·, 2H]); the local program aggregates
the raw 602-wide rows, as the JAX tool's does, so the difference can come
out negative.

``virtual``: relative weak scaling of the same dist step (float32) at 1,
2, 4 and 8 gloo ranks on the CPU, one process each
(``parallel/ranks.py``), on a 40,000-node graph, 128 features, b_loc 512,
hidden 64.  It never touches the card, whatever ``--device`` says.

Each program is timed as the JAX tool times it: one warm step, the params
reset, then REPS steps chained on the same device-resident arguments with
one synchronisation at the end.  Beside the JAX tool's keys a row records
the kernel launches of its timed chains and the card's power limit.  Rows
are merged into ``HALO_OVERHEAD.json`` in the output directory by (mode,
n_dev).

    python -m graphsage_torch.halo_overhead [chip|virtual] [--out DIR]

Without a card ``chip`` raises unless ``--device cpu`` is given (gloo,
world 1).  ``--nodes`` and ``--edges`` shrink the graph for tests and CPU
drives only.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import common_args, setup_device, \
    write_merged
from graphsage_torch.convert import params_to_numpy
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models import (GraphSageConfig, classifier_apply,
                                    init_classifier, init_graphsage)
from graphsage_torch.models.graphsage import compute_dtype, graphsage_apply
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.parallel import multihost
from graphsage_torch.parallel.halo import shard_features
from graphsage_torch.parallel.ranks import run_ranks
from graphsage_torch.train.dense import cast_compute, edges_per_batch
from graphsage_torch.train.distributed import (build_dist_batch,
                                               dist_batch_to_device,
                                               make_dist_sup_step)
from graphsage_torch.train.optim import apply_gradients
from graphsage_torch.train.trainer import _leaf_params

REPS = 10
NODES, EDGES, FEATS, CLASSES, HIDDEN, FANOUT = (100_000, 1_000_000, 602, 16,
                                                128, 10)
V_NODES, V_EDGES, V_FEATS, V_CLASSES, V_HIDDEN, V_B_LOC = (40_000, 400_000,
                                                           128, 8, 64, 512)
V_WORLDS = (1, 2, 4, 8)
LR, CLIP = 0.7, 5.0
OUT_FILE = "HALO_OVERHEAD.json"
CHIP_NOTE = ("world 1 over {backend}: the halo plan is all-local, so the "
             "delta is pure exchange/assembly cost (two all_to_alls + "
             "request tables + address translation) at identical frontiers "
             "(x0_ids replay oracle); the dist step sends W1's transform of "
             "the rows ([., 2H]), the oracle gathers and aggregates the raw "
             "rows")


def chain_timed(first_args_fn, step_fn, dev: torch.device,
                reps: int = REPS) -> tuple[float, dict]:
    """ms a step of ``reps`` chained ``step_fn(params, *args)`` calls (the
    params updated in place, one synchronisation at the end), after one
    warm step and a reset of the params; with the chain's kernel
    launches."""
    params, args = first_args_fn()
    float(step_fn(params, *args))          # warm
    params, args = first_args_fn()
    bench.sync(dev)
    agg.reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        step_fn(params, *args)
    bench.sync(dev)
    ms = (time.perf_counter() - t0) / reps * 1e3
    return ms, dict(agg.LAUNCHES)


def port_params(cfg: GraphSageConfig, num_classes: int) -> dict:
    """The port's init from a generator seeded 824, as numpy arrays."""
    gen = torch.Generator().manual_seed(824)
    return params_to_numpy({
        "sage": init_graphsage(gen, cfg),
        "clf": init_classifier(gen, cfg.out_size, num_classes)})


def make_local_step(mcfg: GraphSageConfig, lr: float = LR,
                    clip: float = CLIP):
    """The JAX tool's ``local_step`` (``tools/halo_overhead.py:101-129``):
    ``step(params, feats, x0_ids, frontiers, labels, row_mask) -> loss``.
    The layer-0 rows by their global ids from the whole table, the encode
    and the classifier on the params rounded to the compute dtype, the
    NLL, then one backward, a clip per model and SGD on ``params`` in
    place."""
    def step(params, feats, x0_ids, frontiers, labels, row_mask):
        p = cast_compute(params, mcfg)
        x0 = gather_rows(feats, x0_ids)
        embs = graphsage_apply(p["sage"], mcfg, x0, frontiers)
        logp = classifier_apply(p["clf"], embs)
        loss = supervised_nll(logp, labels, row_mask)
        apply_gradients(params, loss, ("sage", "clf"), lr, clip)
        return loss.detach()

    return step


def chip_batch(ds, b_loc: int):
    """The chip mode's batch: ``RandomState(7).choice`` of (1, b_loc) train
    nodes, its frontiers drawn with seed 99."""
    rng = np.random.RandomState(7)
    batch = ds.train_nodes[rng.choice(len(ds.train_nodes), (1, b_loc))]
    return build_dist_batch(ds.graph, ds.labels, batch, 2, fanout=FANOUT,
                            seed=99)


def run_chip(ds=None, dev: torch.device | None = None, b_loc: int = 4096,
             dtype: str = "bfloat16", params: dict | None = None,
             first_losses: dict | None = None) -> list:
    """The ``chip_mesh1_overhead`` row.  ``ds`` defaults to the 100,000-node
    graph, ``params`` (numpy) to :func:`port_params`.  ``first_losses``,
    when given, receives the first loss of each program (one step of each
    from the same params)."""
    if ds is None:
        ds = synthetic_power_law(NODES, EDGES, num_feats=FEATS,
                                 num_classes=CLASSES, seed=0)
    dev = torch.device("cuda") if dev is None else dev
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=HIDDEN, compute_dtype=dtype)
    if params is None:
        params = port_params(mcfg, ds.num_classes)
    db = chip_batch(ds, b_loc)
    owned = not dist.is_initialized()
    dev = multihost.initialize(dev)
    try:
        if dist.get_world_size() != 1:
            raise ValueError(f"chip mode runs at world 1, not in a group "
                             f"of {dist.get_world_size()}")
        note = CHIP_NOTE.format(backend=dist.get_backend())
        feats = torch.from_numpy(ds.features).to(dev, compute_dtype(mcfg))
        t = dist_batch_to_device(db, dev)
        dist_step = make_dist_sup_step(mcfg, lr=LR, clip=CLIP)

        def dist_args():
            return _leaf_params(params, dev), (feats, t)

        x0_ids = torch.from_numpy(db.x0_ids[0]).to(dev)
        local_step = make_local_step(mcfg)
        local_inputs = (feats, x0_ids, t["frontiers"], t["labels"],
                        t["row_mask"])

        def local_args():
            return _leaf_params(params, dev), local_inputs

        if first_losses is not None:
            first_losses["dist_step"] = float(dist_step(
                _leaf_params(params, dev), feats, t))
            first_losses["local_oracle"] = float(local_step(
                _leaf_params(params, dev), *local_inputs))
        dist_ms, dist_launches = chain_timed(dist_args, dist_step, dev)
        local_ms, local_launches = chain_timed(local_args, local_step, dev)
    finally:
        if owned:
            multihost.shutdown()
    edges = edges_per_batch(b_loc, mcfg.num_layers, FANOUT)
    device, power_limit = bench.card(dev)
    row = {
        "mode": "chip_mesh1_overhead",
        "device": device,
        "b_loc": b_loc, "dtype": dtype,
        "dist_step_ms": round(dist_ms, 3),
        "local_oracle_ms": round(local_ms, 3),
        "halo_overhead_ms": round(dist_ms - local_ms, 3),
        "halo_overhead_pct": round((dist_ms - local_ms) / local_ms * 100,
                                   1),
        "dist_edges_per_sec": round(edges / (dist_ms / 1e3), 1),
        "note": note,
        "power_limit": power_limit,
        "launches": {"dist_step": dist_launches,
                     "local_oracle": local_launches},
    }
    return [row]


def virtual_rank(payload: dict, rank: int, world: int) -> dict:
    """One gloo rank of the virtual mode: its shard of the padded feature
    table and its row of the batch; the dist step chained and timed."""
    cpu = torch.device("cpu")
    mcfg = GraphSageConfig(**payload["cfg"])
    feats = payload["feats"]
    rows_per = feats.shape[0] // world
    feats_local = torch.from_numpy(
        np.ascontiguousarray(feats[rank * rows_per:(rank + 1) * rows_per]))
    t = dist_batch_to_device(payload["batch"], cpu)
    step = make_dist_sup_step(mcfg, lr=LR, clip=CLIP)
    ms, launches = chain_timed(
        lambda: (_leaf_params(payload["params"], cpu), (feats_local, t)),
        step, cpu)
    return {"ms": ms, "launches": launches}


def virtual_payloads(ds=None, worlds=V_WORLDS, b_loc: int = V_B_LOC,
                     hidden: int = V_HIDDEN):
    """(world, payload) for each world: a fresh ``RandomState(7)`` draws
    its (world, b_loc) batch, the frontiers with seed 99."""
    if ds is None:
        ds = synthetic_power_law(V_NODES, V_EDGES, num_feats=V_FEATS,
                                 num_classes=V_CLASSES, seed=0)
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=hidden)
    params = port_params(mcfg, ds.num_classes)
    for n_dev in worlds:
        rng = np.random.RandomState(7)
        batch = ds.train_nodes[rng.choice(len(ds.train_nodes),
                                          (n_dev, b_loc))]
        db = build_dist_batch(ds.graph, ds.labels, batch, mcfg.num_layers,
                              fanout=FANOUT, seed=99)
        yield n_dev, {"cfg": {"num_layers": 2,
                              "input_size": ds.feature_dim,
                              "out_size": hidden},
                      "params": params, "batch": db,
                      "feats": shard_features(ds.features, n_dev)}


def run_virtual(ds=None, worlds=V_WORLDS, b_loc: int = V_B_LOC,
                hidden: int = V_HIDDEN, log=print) -> list:
    """The ``virtual_weak_scaling`` rows, then the note."""
    rows, base = [], None
    for n_dev, payload in virtual_payloads(ds, worlds, b_loc, hidden):
        res = run_ranks("graphsage_torch.halo_overhead:virtual_rank",
                        payload, n_dev)[0]
        ms = res["ms"]
        edges = edges_per_batch(n_dev * b_loc, 2, FANOUT)
        eps = edges / (ms / 1e3)
        if base is None:
            base = eps
        rows.append({"mode": "virtual_weak_scaling", "n_dev": n_dev,
                     "b_loc": b_loc, "step_ms": round(ms, 3),
                     "edges_per_sec": round(eps, 1),
                     "efficiency_vs_1dev": round(eps / (base * n_dev), 3),
                     "host_cpus": os.cpu_count(),
                     "launches": res["launches"]})
        log("#", json.dumps(rows[-1]))
    rows.append({
        "mode": "virtual_weak_scaling_note",
        "note": (f"{os.cpu_count()}-core host: total compute grows with "
                 "n_dev but the gloo rank processes share the host's "
                 "cores (cores / n_dev threads each), so efficiency beyond "
                 "n_dev=cpus measures host-core contention, NOT the "
                 "collective design.  The gloo ranks validate correctness "
                 "and that the per-step collective payload stays flat "
                 "(2·N·H bytes regardless of P, parallel/halo.py); "
                 "absolute scaling requires real cards.")})
    return rows


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="chip",
                    choices=["chip", "virtual"])
    ap.set_defaults(nodes=None, edges=None)
    args = ap.parse_args(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    if args.mode == "virtual":
        ds = (None if args.nodes is None else synthetic_power_law(
            args.nodes, args.edges or 10 * args.nodes, num_feats=V_FEATS,
            num_classes=V_CLASSES, seed=0))
        rows = run_virtual(ds, log=log)
    else:
        dev = setup_device(args.device)
        ds = (None if args.nodes is None else synthetic_power_law(
            args.nodes, args.edges or 10 * args.nodes, num_feats=FEATS,
            num_classes=CLASSES, seed=0))
        rows = run_chip(ds, dev)
    for r in rows:
        log("#", json.dumps(r))
    path = write_merged({"rows": rows}, args.out, OUT_FILE,
                        key=lambda r: (r.get("mode"), r.get("n_dev")))
    print(json.dumps(rows))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
