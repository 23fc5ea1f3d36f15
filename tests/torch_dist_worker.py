"""Rank bodies for the port's distributed tests, and the launchers that
run them (``run_ranks``; ``run_cli_ranks`` for the CLI under torchrun).

Each rank is its own process, started by the package's rank launcher
(``graphsage_torch.parallel.ranks``) with the repository on its path and
one thread.  It joins a gloo group over a ``file://`` rendezvous in a
temporary directory of its own (several test files run at once: no fixed
port), runs every job of the pickled list (``run_jobs``), and hands back
{job name: result}.  The module imports no JAX and nothing of the JAX
package: the parent test computes the JAX side and compares.

Jobs are (name, task, payload) with numpy payloads; the tasks:

- ``comm``: all_to_all_rows and all_gather_rows forward and backward,
  mean_over_ranks, on arrays drawn from RandomState(seed + rank);
- ``halo``: the exchange (make_halo_gather, halo_gather_local) forward
  and d(sum(out * cot)) / d(feats);
- ``dist_step``: one make_dist_sup_step / make_dist_unsup_step step;
- ``dist_forward``: make_dist_forward, the evaluation forward;
- ``cached_epoch``: local_refresh, then cached_epoch_reuse over a
  CachedDistStep on the rank's row of the epoch stack, the draws replayed
  (``draws``) or from the port's own sampler (``sampler_seed``);
- ``infer``: full_graph_embeddings_sharded;
- ``mesh_step``: make_mesh, shard_params, then one tensor-parallel
  make_dense_sup_step(mesh=...) step on replayed global draws, and the
  params gathered back;
- ``mesh_errors``: the ValueErrors of make_mesh on a mesh that does not
  fit the group;
- ``dryrun``: entry.dryrun_multichip over the group.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from graphsage_torch import entry  # noqa: E402
from graphsage_torch.convert import params_to_numpy  # noqa: E402
from graphsage_torch.data.graph import PaddedAdjacency  # noqa: E402
from graphsage_torch.infer import full_graph_embeddings_sharded  # noqa: E402
from graphsage_torch.models import Frontier, GraphSageConfig  # noqa: E402
from graphsage_torch.parallel import comm, mesh, ranks  # noqa: E402
from graphsage_torch.parallel.halo import make_halo_gather  # noqa: E402
from graphsage_torch.sampler.device import HopSampler  # noqa: E402
from graphsage_torch.train.cached import cached_epoch_reuse  # noqa: E402
from graphsage_torch.train.cached_dist import (CachedDistStep,  # noqa: E402
                                               local_refresh, local_rows)
from graphsage_torch.train.dense import make_dense_sup_step  # noqa: E402
from graphsage_torch.train.distributed import (  # noqa: E402
    DistBatch, dist_batch_to_device, make_dist_forward, make_dist_sup_step,
    make_dist_unsup_step, pairs_to_device)
from graphsage_torch.train.trainer import _leaf_params  # noqa: E402

CPU = torch.device("cpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy().copy()


class ReplayHop:
    """A hop sampler that returns recorded (samples, valid) draws in
    order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, nodes, fanout):
        samples, valid = self.draws.pop(0)
        assert samples.shape == (nodes.shape[0], fanout)
        return _t(samples), _t(valid)


def task_comm(p, rank, world):
    rng = np.random.RandomState(p["seed"] + rank)
    out = {}
    for name, dtype in DTYPES.items():
        x = _t(rng.randn(world, 3, 5).astype(np.float32)).to(dtype)
        x.requires_grad_(True)
        cot = _t(rng.randn(world, 3, 5).astype(np.float32))
        y = comm.all_to_all_rows(x)
        (y.float() * cot).sum().backward()
        z = _t(rng.randn(2, 4).astype(np.float32)).to(dtype)
        z.requires_grad_(True)
        cot2 = _t(rng.randn(world * 2, 4).astype(np.float32))
        full = comm.all_gather_rows(z)
        (full.float() * cot2).sum().backward()
        c = _t(rng.randn(3, 2).astype(np.float32)).to(dtype)
        c.requires_grad_(True)
        cot3 = _t(rng.randn(3, world * 2).astype(np.float32))
        cols = comm.all_gather_cols(c)
        (cols.float() * cot3).sum().backward()
        s = _t(rng.randn(4, 3).astype(np.float32)).to(dtype)
        s.requires_grad_(True)
        cot4 = _t(rng.randn(4, 3).astype(np.float32))
        summed = comm.sum_partials(s)
        (summed.float() * cot4).sum().backward()
        out[name] = {"x": _np(x), "cot": _np(cot), "y": _np(y),
                     "dx": _np(x.grad), "z": _np(z), "cot2": _np(cot2),
                     "full": _np(full), "dz": _np(z.grad), "c": _np(c),
                     "cot3": _np(cot3), "cols": _np(cols),
                     "dc": _np(c.grad), "s": _np(s), "cot4": _np(cot4),
                     "summed": _np(summed), "ds": _np(s.grad)}
    req = _t(rng.randint(0, 100, (world, 6)).astype(np.int32))
    out["int32"] = {"x": req.numpy(), "y": comm.all_to_all_rows(req).numpy()}
    a = _t(rng.randn(7).astype(np.float32))
    b = _t(rng.randn(2, 3).astype(np.float32))
    out["mean"] = {"a": a.numpy(), "b": b.numpy(),
                   "got": [_np(t) for t in comm.mean_over_ranks([a, b])]}
    return out


def task_halo(p, rank, world):
    rows_per = p["feats"].shape[0] // world
    local = _t(p["feats"][rank * rows_per:(rank + 1) * rows_per]).to(
        DTYPES[p["dtype"]]).requires_grad_(True)
    pl = p["plan"]
    out = make_halo_gather()(
        local, _t(pl["requests"][rank]), _t(pl["addr_owner"][rank]),
        _t(pl["addr_slot"][rank]), _t(pl["addr_is_local"][rank]),
        _t(pl["addr_local"][rank]))
    (out.float() * _t(p["cot"][rank])).sum().backward()
    return {"out": _np(out), "grad": _np(local.grad)}


def _batch(db: dict) -> DistBatch:
    return DistBatch(**{**db, "frontiers": [Frontier(**f)
                                            for f in db["frontiers"]]})


def task_dist_step(p, rank, world):
    cfg = GraphSageConfig(**p["cfg"])
    params = _leaf_params(p["params"], CPU)
    rows_per = p["feats"].shape[0] // world
    feats_local = _t(p["feats"][rank * rows_per:(rank + 1) * rows_per]).to(
        DTYPES[cfg.compute_dtype])
    t = dist_batch_to_device(_batch(p["batch"]), CPU)
    method = p["learn_method"]
    if method == "sup":
        step = make_dist_sup_step(cfg, lr=p["lr"], clip=p["clip"])
        loss = step(params, feats_local, t)
    else:
        step = make_dist_unsup_step(cfg, unsup_loss=p["unsup_loss"],
                                    learn_method=method, lr=p["lr"],
                                    clip=p["clip"], q=p["q"],
                                    margin=p["margin"])
        loss = step(params, feats_local, t,
                    pairs_to_device(p["pairs"], CPU))
    return {"loss": float(loss), "params": params_to_numpy(params)}


def task_dist_forward(p, rank, world):
    """make_dist_forward over the float32 feature shard with the float32
    params, as DistTrainer evaluates."""
    cfg = GraphSageConfig(**p["cfg"])
    params = _leaf_params(p["params"], CPU)
    rows_per = p["feats"].shape[0] // world
    feats_local = _t(p["feats"][rank * rows_per:(rank + 1) * rows_per])
    t = dist_batch_to_device(_batch(p["batch"]), CPU)
    embs = make_dist_forward(cfg)(params["sage"], feats_local, t)
    return {"embs": _np(embs), "dtype": str(embs.dtype)}


def task_cached_epoch(p, rank, world):
    cfg = GraphSageConfig(**p["cfg"])
    params = _leaf_params(p["params"], CPU)
    feats = _t(p["feats"]).to(DTYPES[cfg.compute_dtype])
    neighbors, degrees = _t(p["neighbors"]), _t(p["degrees"])
    if p.get("draws") is not None:
        hop = ReplayHop(p["draws"][rank])
    else:
        hop = HopSampler(neighbors, degrees, torch.Generator().manual_seed(
            p["sampler_seed"] + rank))
    agg = "MAX" if cfg.agg_func == "MAX" else "MEAN"
    cache = local_refresh(hop, feats, p["fanout"], agg, rank, world)
    step = CachedDistStep(cfg, learn_method=p["learn_method"],
                          unsup_loss=p.get("unsup_loss", "normal"),
                          fanout=p["fanout"], lr=p["lr"], clip=p["clip"])
    stack = [_t(a[:, rank]) for a in p["stack"]]
    pairs = p.get("pairs")
    if pairs is not None:
        pairs = {k: _t(v[:, rank]) for k, v in pairs.items()}
    losses = cached_epoch_reuse(step, params, local_rows(feats, rank, world),
                                *cache, hop, *stack, pairs)
    if isinstance(hop, ReplayHop):
        assert not hop.draws, "draws left over"
    return {"losses": _np(losses), "params": params_to_numpy(params),
            "cache": _np(cache[0]), "count": _np(cache[1])}


def task_infer(p, rank, world):
    cfg = GraphSageConfig(**p["cfg"])
    pad = PaddedAdjacency(neighbors=p["neighbors"], degrees=p["degrees"],
                          true_degrees=p["degrees"], truncated=False)
    return full_graph_embeddings_sharded(
        p["params"], cfg, p["feats"], pad, lstm_hybrid=p["lstm_hybrid"],
        device="cpu")


def task_mesh_step(p, rank, world):
    """One rank of the (n_data x n_model) tensor-parallel dense step: its
    shard_params before the step, the loss, its slices after, and the
    params gathered back."""
    cfg = GraphSageConfig(**p["cfg"])
    m = mesh.make_mesh(p["n_data"], p["n_model"])
    local = mesh.shard_params(_leaf_params(p["params"], CPU), m)
    shards = params_to_numpy(local)
    step = make_dense_sup_step(cfg, fanout=p["fanout"], lr=p["lr"],
                               clip=p["clip"], mesh=m)
    hop = ReplayHop(p["draws"])
    loss = step(local, _t(p["feats"]), hop, _t(p["batch"]), _t(p["labels"]))
    assert not hop.draws, "draws left over"
    return {"data_rank": m.data_rank, "model_rank": m.model_rank,
            "shards": shards, "loss": float(loss),
            "local": params_to_numpy(local),
            "gathered": params_to_numpy(mesh.gather_params(local, m))}


def task_mesh_errors(p, rank, world):
    out = {}
    for name, (n_data, n_model) in p["meshes"].items():
        try:
            mesh.make_mesh(n_data, n_model)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def task_dryrun(p, rank, world):
    return entry.dryrun_multichip(world, device="cpu")


TASKS = {"comm": task_comm, "halo": task_halo, "dist_step": task_dist_step,
         "dist_forward": task_dist_forward,
         "cached_epoch": task_cached_epoch, "infer": task_infer,
         "mesh_step": task_mesh_step, "mesh_errors": task_mesh_errors,
         "dryrun": task_dryrun}


def run_jobs(jobs: list, rank: int, world: int) -> dict:
    """A rank's body (``graphsage_torch.parallel.ranks``): every job of the
    list, as {job name: result}."""
    return {name: TASKS[task](payload, rank, world)
            for name, task, payload in jobs}


def run_ranks(jobs: list, world: int, timeout_s: float = 240):
    """Run ``jobs`` on ``world`` gloo ranks, one process each, one thread
    each (``graphsage_torch.parallel.ranks.run_ranks``); returns the ranks'
    {name: result} dicts, rank 0 first.  A rank that fails or outlives
    ``timeout_s`` fails the caller with the ranks' output."""
    return ranks.run_ranks("tests.torch_dist_worker:run_jobs", jobs, world,
                           threads=1, timeout_s=timeout_s)


def run_cli_ranks(args: list, world: int, cwd, timeout_s: float = 240):
    """``torchrun --standalone --nproc_per_node world -m graphsage_torch.cli
    ARGS`` from ``cwd``; returns the completed process (output captured).
    A run that outlives ``timeout_s`` is killed and fails the caller."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "GS_DIST_TIMEOUT_S": "120"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), "-m", "graphsage_torch.cli",
           *args]
    return subprocess.run(cmd, cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=timeout_s)

