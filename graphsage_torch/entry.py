"""Entry points: the flagship forward at tiny shapes, and the
multi-rank dry run.

Port of ``__graft_entry__.py``.

- ``entry()``: the 2-layer MEAN GraphSAGE forward of the dense pipeline
  (``train.dense.dense_forward``, fanout 3) on a 64-node power-law graph
  with 32 features, out_size 32, 4 classes and a batch of 16, as a
  callable and its arguments.
- ``dryrun_multichip(n)``: one step of each of the four parallel programs
  of the JAX package's dry run over the ranks of the current
  ``torch.distributed`` group, each asserted against a replay that the
  rank runs by itself: (1) the data- and tensor-parallel dense supervised
  step over the (n_data x n_model) mesh of ``parallel/mesh.py``, n_model 2
  where n >= 4 and even; (2) the halo-exchange step
  (``train.distributed``); (3) the row-sharded cached epoch
  (``train.cached_dist``); (4) sharded serving
  (``infer.full_graph_embeddings_sharded``).  JAX's shapes, seeds and
  tolerances.

The graphs, features and batches are the JAX package's (the port's data
layer is a bit-identical copy); the weights come from a
``torch.Generator`` seeded like the JAX package's keys, so they differ from
JAX's draws, and the tests carry JAX's params over with
``convert.params_from_jax``.  Sampling draws from ``torch.Generator``s, so
the draws differ from JAX's too; each program's replay draws what its
parallel run draws.

    from graphsage_torch.entry import entry
    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    embs = fn(*args)            # [16, 32]

    python -m graphsage_torch.entry                 # world 1, on the card
    torchrun --standalone --nproc_per_node 4 -m graphsage_torch.entry \\
        --device cpu                                # 4 ranks over gloo

The command runs ``entry()``'s forward and then ``dryrun_multichip`` over
the group it forms (``parallel.multihost.initialize``: torchrun's world,
or world 1 in process); rank 0 prints a line a program.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.infer import (_resolve_device, full_graph_embeddings,
                                   full_graph_embeddings_sharded)
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models import (Frontier, GraphSageConfig,
                                    init_classifier, init_graphsage)
from graphsage_torch.models.graphsage import graphsage_apply
from graphsage_torch.models.layers import classifier_apply
from graphsage_torch.parallel import comm, mesh as pmesh, multihost
from graphsage_torch.parallel.halo import shard_features
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.cached import (CachedStep, cached_epoch_reuse,
                                          refresh_leaf_cache)
from graphsage_torch.train.cached_dist import (CachedDistStep,
                                               build_epoch_stack,
                                               local_refresh, local_rows,
                                               pad_node_tables, rank_seed)
from graphsage_torch.train.dense import dense_forward, make_dense_sup_step
from graphsage_torch.train.distributed import (build_dist_batch,
                                               dist_batch_to_device,
                                               make_dist_sup_step)
from graphsage_torch.train.trainer import _leaf_params
from graphsage_torch.utils.obs import collective_watchdog

FANOUT = 3


def _put(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def entry(device: str | torch.device | None = None):
    """Returns (fn, example_args): ``fn(params, feats, hop, batch)`` is the
    flagship forward, [16] -> [16, 32]; it runs on the card unless
    ``device="cpu"`` is given."""
    dev = _resolve_device(device)
    ds = synthetic_power_law(64, 64 * 6, num_feats=32, num_classes=4, seed=0)
    pad = ds.graph.to_padded()
    mcfg = GraphSageConfig(num_layers=2, input_size=32, out_size=32)
    gen = torch.Generator().manual_seed(0)
    params = {"sage": init_graphsage(gen, mcfg),
              "clf": init_classifier(gen, mcfg.out_size, 4)}
    batch = np.random.RandomState(0).choice(64, 16, replace=False)

    def forward(params, feats, hop, batch):
        return dense_forward(params, mcfg, feats, hop, batch, fanout=FANOUT)

    hop = HopSampler(_put(pad.neighbors, dev), _put(pad.degrees, dev),
                     torch.Generator(device=dev).manual_seed(1))
    return forward, (params_from_jax(params, dev), _put(ds.features, dev),
                     hop, _put(batch.astype(np.int32), dev))


def _close(got: float, want: float, what: str) -> None:
    assert np.isfinite(got), (what, got)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (
        f"{what} loss {got} != single-process replay {want}")


def _tensor_parallel_program(n: int, dev: torch.device) -> str:
    """Program 1: the dense sup step over the (n_data x n_model) mesh,
    against the single-device step on the same draws (each run's hop
    seeded alike)."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    mesh = pmesh.make_mesh(n_data, n_model)
    fanout, batch = 10, 16 * n_data
    ds = synthetic_power_law(512, 4096, num_feats=64, num_classes=6, seed=0)
    pad = ds.graph.to_padded()
    mcfg = GraphSageConfig(num_layers=2, input_size=64, out_size=32)
    gen = torch.Generator().manual_seed(0)
    params = _leaf_params({"sage": init_graphsage(gen, mcfg),
                           "clf": init_classifier(gen, 32, 6)}, dev)
    nodes = np.random.RandomState(0).choice(512, batch,
                                            replace=batch > 512)
    batch_t = _put(nodes.astype(np.int32), dev)
    labels = _put(ds.labels[nodes].astype(np.int32), dev)
    feats = _put(ds.features, dev)

    def hop():
        return HopSampler(_put(pad.neighbors, dev), _put(pad.degrees, dev),
                          torch.Generator(device=dev).manual_seed(0))

    # the replay first, on copies: the sharded step updates its slices
    replay = make_dense_sup_step(mcfg, fanout=fanout)
    loss_ref = float(replay(_leaf_params(params, dev), feats, hop(),
                            batch_t, labels))
    step = make_dense_sup_step(mcfg, fanout=fanout, mesh=mesh)
    with collective_watchdog(label="dryrun tensor-parallel dense step"):
        loss = float(step(pmesh.shard_params(params, mesh), feats, hop(),
                          batch_t, labels))
    _close(loss, loss_ref, "tensor-parallel step")
    return (f"dryrun_multichip({n}): data- and tensor-parallel dense step "
            f"mesh=({n_data}x{n_model}) loss={loss:.4f} == replay OK")


def _halo_program(n: int, rank: int, ds, mcfg, params,
                  dev: torch.device) -> str:
    """Program 2: the halo-exchange step (1201 nodes: an uneven last
    feature shard; the last rank's batch tail masked), against the mean of
    the per-shard losses over the same frontiers without the exchange."""
    b_loc = 24
    rs = np.random.RandomState(0)
    batch = ds.train_nodes[rs.choice(len(ds.train_nodes), (n, b_loc))]
    valid = np.ones((n, b_loc), bool)
    valid[-1, b_loc // 3:] = False
    db = build_dist_batch(ds.graph, ds.labels, batch, 2, fanout=10, seed=0,
                          valid=valid)
    feats_padded = _put(shard_features(ds.features, n), dev)
    rows_per = feats_padded.shape[0] // n
    step = make_dist_sup_step(mcfg, lr=0.5)
    with collective_watchdog(label="dryrun halo edge-partition step"):
        loss = float(step(_leaf_params(params, dev),
                          feats_padded[rank * rows_per:(rank + 1) * rows_per],
                          dist_batch_to_device(db, dev)))
    total = 0.0
    with torch.no_grad():
        for d in range(n):
            x0 = feats_padded[_put(db.x0_ids[d], dev).long()]
            frontiers = [Frontier(idx=_put(f.idx[d], dev),
                                  mask=_put(f.mask[d], dev),
                                  self_idx=_put(f.self_idx[d], dev))
                         for f in db.frontiers]
            embs = graphsage_apply(params["sage"], mcfg, x0, frontiers)
            logp = classifier_apply(params["clf"], embs)
            total += float(supervised_nll(logp, _put(db.labels[d], dev),
                                          _put(db.row_mask[d], dev)))
    _close(loss, total / n, "halo step")
    return (f"dryrun_multichip({n}): halo edge-partition step (1201 nodes, "
            f"uneven shard+tail, fanout 10) loss={loss:.4f} == replay OK")


def _cached_program(n: int, rank: int, ds, mcfg, params,
                    dev: torch.device) -> str:
    """Program 3: the sharded cached epoch (T = 3 steps, b = 6·n) against
    the single-device cached epoch; take-all fanout, so every draw takes
    the same sets and only the sums' order differs."""
    pad = ds.graph.to_padded()
    feats, neigh, deg = pad_node_tables(ds.features, pad.neighbors,
                                        pad.degrees, n)
    feats, neigh, deg = _put(feats, dev), _put(neigh, dev), _put(deg, dev)
    fan = neigh.shape[1]
    t, b = 3, n * 6
    batches, labels, masks = build_epoch_stack(
        ds.train_nodes, ds.labels, n, b, np.random.RandomState(2))
    batches, labels, masks = (_put(a[:t], dev) for a in (batches, labels,
                                                          masks))

    def hop(seed):
        return HopSampler(neigh, deg,
                          torch.Generator(device=dev).manual_seed(seed))

    h = hop(3)
    single = CachedStep(mcfg, fanout=fan)
    losses_ref = cached_epoch_reuse(
        single, _leaf_params(params, dev), feats,
        *refresh_leaf_cache(h, feats, fan), h, batches.reshape(t, b),
        labels.reshape(t, b))
    h = hop(rank_seed(3, rank))
    cache = local_refresh(h, feats, fan, "MEAN", rank, n)
    with collective_watchdog(label="dryrun sharded cached epoch"):
        losses = cached_epoch_reuse(
            CachedDistStep(mcfg, fanout=fan), _leaf_params(params, dev),
            local_rows(feats, rank, n), *cache, h, batches[:, rank],
            labels[:, rank], masks[:, rank])
    assert torch.allclose(losses, losses_ref, rtol=1e-4, atol=1e-4), (
        losses, losses_ref)
    return (f"dryrun_multichip({n}): sharded cached epoch (T={t} steps, "
            f"row-sharded layer-1 table) losses == single-device replay OK")


def _serving_program(n: int, ds, mcfg, params, dev: torch.device) -> str:
    """Program 4: sharded full-graph inference against the single-device
    propagation."""
    pad = ds.graph.to_padded()
    want = full_graph_embeddings(params["sage"], mcfg, ds.features, pad,
                                 device=dev)
    with collective_watchdog(label="dryrun sharded full-graph inference"):
        got = full_graph_embeddings_sharded(params["sage"], mcfg,
                                            ds.features, pad, device=dev)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-5), (
        float(np.abs(got - want).max()))
    return (f"dryrun_multichip({n}): sharded full-graph inference "
            f"({ds.num_nodes} nodes, uneven row shards) == single-device OK")


def dryrun_multichip(n_devices: int | None = None,
                     device: str | torch.device | None = None) -> list[str]:
    """One step of each parallel program over the ``n_devices`` ranks of
    the current group (formed here if it is not yet: see
    ``parallel.multihost.initialize``; ``n_devices`` defaults to its
    size), each asserted against a replay that the rank runs by itself.
    Every rank of the group calls it; rank 0 prints a line a program, and
    every rank returns the lines.  On the card unless ``device`` names
    the CPU."""
    dev = multihost.initialize(device)
    rank, world = comm.rank_world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"dryrun_multichip({n}) runs on a group of {n} "
                         f"ranks, this one has {world}")
    lines = [_tensor_parallel_program(n, dev)]
    ds = synthetic_power_law(1201, 12000, num_feats=64, num_classes=6,
                             seed=1)
    mcfg = GraphSageConfig(num_layers=2, input_size=64, out_size=32)
    gen = torch.Generator().manual_seed(7)
    params = params_from_jax({"sage": init_graphsage(gen, mcfg),
                              "clf": init_classifier(gen, 32, 6)}, dev)
    lines.append(_halo_program(n, rank, ds, mcfg, params, dev))
    lines.append(_cached_program(n, rank, ds, mcfg, params, dev))
    lines.append(_serving_program(n, ds, mcfg, params, dev))
    if rank == 0:
        print("\n".join(lines), flush=True)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m graphsage_torch.entry",
        description="entry()'s forward, then dryrun_multichip over the "
                    "group (torchrun's world, or world 1)")
    parser.add_argument("--device", default=None,
                        help="cpu: gloo on the CPU; default the card (NCCL)")
    args = parser.parse_args(argv)
    dev = multihost.initialize(args.device)
    try:
        fn, fn_args = entry(dev)
        with torch.no_grad():
            out = fn(*fn_args)
        if comm.rank_world()[0] == 0:
            print(f"entry forward: {tuple(out.shape)}", flush=True)
        dryrun_multichip(device=dev)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
