"""The cached pipeline's step time taken apart on the card: the port of the
JAX system's ``tools/profile_cached.py``.

At the bench's headline shape (the 100,000-node graph, 602 features,
hidden 128, B 32768, fanout 10, table width 32) each row times a program
that runs its op ``ITERS`` times: one warm call, then the median of 3
calls, each between two synchronisations, divided by ``ITERS``.  Every
iteration does the op's whole work (eager PyTorch hoists nothing, so the
JAX tool's checksum carry has no counterpart; its rolled ids stay).  For
float32 and bfloat16 compute: the refresh (of the float32 table, in both),
the full train step, the forward alone, forward and backward (of the sum
of the embeddings) and the layer-1 full-table GEMM; then the sampling of
the L-1 hops; then at the step's frontier size, M = B·(K+1) uniform ids
rolled ``(i + off) % n`` each iteration, over a [N, 128] table in float32
and bfloat16:

- ``gather_*``: the ``gather_rows`` kernel;
- ``scatter_add_*``: the gather's backward added into the carried table:
  ``index_add_`` in float32, the ``scatter_rows`` kernel and an add in
  bfloat16;
- ``sort_segsum_*``: ``torch.sort`` of the ids, the values in that order,
  ``index_add_`` and an add (plain PyTorch, for comparison).

Beside the JAX tool's keys each row records its kernel launches in one
timed call; the record names the card and its power limit.  Writes
``PROFILE_CACHED.json`` in the output directory.

    python -m graphsage_torch.profile_cached [--out DIR]

Without a card it raises unless ``--device cpu`` is given.  ``--nodes``
and ``--edges`` shrink the graph for tests and CPU drives only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import common_args, setup_device
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models.layers import sage_layer_apply
from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.ops.scatter import scatter_rows
from graphsage_torch.train import cached
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.optim import tree_leaves

B, FANOUT, HIDDEN, ITERS = 32768, 10, 128, 30
OUT_FILE = "PROFILE_CACHED.json"
METHODOLOGY = ("a warm call, then the median of 3 calls of a program that "
               "runs the op x30, each between two synchronisations, "
               "divided by 30")


def dev_time(program, dev: torch.device):
    """(ms an iteration: the median of 3 synchronised calls of
    ``program`` after a warm one, divided by ITERS; the kernel launches
    of the first timed call)."""
    s, _, launches, _ = bench.timed_calls(program, dev, 3)
    return s / ITERS * 1e3, launches


def uniform_ids(n: int, m: int) -> np.ndarray:
    """The isolated rows' ids: ``RandomState(0)`` after the batch's draw
    of B, M more over [0, n)."""
    rng = np.random.RandomState(0)
    rng.randint(0, n, size=B)
    return rng.randint(0, n, size=m).astype(np.int32)


def step_programs(mcfg, params: dict, feats, cache_feats, cache_count, hop,
                  batch, labels, fanout: int = FANOUT) -> dict:
    """The per-dtype rows' programs (``refresh``, ``full_step``,
    ``forward_only``, ``fwd_bwd``, ``gemm``): each runs ITERS iterations
    and returns the last one's result.  ``full_step`` updates ``params`` in
    place and returns the ITERS losses."""
    step = cached.CachedStep(mcfg, fanout=fanout)

    def refresh():
        for _ in range(ITERS):
            out = cached.refresh_leaf_cache(hop, feats, fanout)
        return out

    def full_step():
        return torch.stack([step(params, feats, cache_feats, cache_count,
                                 hop, batch, labels) for _ in range(ITERS)])

    def embs(p):
        sampled = cached.sample_cached_frontiers(hop, batch, mcfg, fanout)
        return cached.cached_forward(p, mcfg, feats, cache_feats,
                                     cache_count, *sampled, fanout)

    @torch.no_grad()
    def forward_only():
        for _ in range(ITERS):
            out = embs(params)
        return out

    def fwd_bwd():
        leaves = tree_leaves(params)
        for _ in range(ITERS):
            loss = embs(params).float().sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), grads

    @torch.no_grad()
    def gemm():
        w = cast_compute(params["sage"]["layers"][0], mcfg)
        f, mf = cast_compute(feats, mcfg), cast_compute(cache_feats, mcfg)
        for _ in range(ITERS):
            out = sage_layer_apply(w, f, mf, gcn=False)
        return out

    return {"refresh": refresh, "full_step": full_step,
            "forward_only": forward_only, "fwd_bwd": fwd_bwd, "gemm": gemm}


def sampling_program(mcfg, hop, batch, fanout: int = FANOUT):
    """ITERS draws of the L-1 hops; returns the last."""
    def sampling():
        for _ in range(ITERS):
            out = cached.sample_cached_frontiers(hop, batch, mcfg, fanout)
        return out

    return sampling


def movement_programs(table, ids, values) -> dict:
    """The isolated rows' programs at ids rolled ``(ids + off) % n`` for
    off in 0..ITERS-1: ``gather`` returns the last gather; ``scatter_add``
    and ``sort_segsum`` add every iteration's ``values`` into a copy of
    ``table`` they carry, and return it."""
    n = table.shape[0]

    def gather():
        for off in range(ITERS):
            out = gather_rows(table, (ids + off) % n)
        return out

    def scatter_add():
        t = table.clone()
        for off in range(ITERS):
            i = (ids + off) % n
            if t.dtype == torch.bfloat16:
                t = t + scatter_rows(values, i, n)
            else:
                t.index_add_(0, i, values)
        return t

    def sort_segsum():
        t = table.clone()
        for off in range(ITERS):
            ii, order = torch.sort((ids + off) % n)
            t = t + torch.zeros_like(t).index_add_(0, ii, values[order])
        return t

    return {"gather": gather, "scatter_add": scatter_add,
            "sort_segsum": sort_segsum}


def run(ds, pad, dev: torch.device, log=print) -> dict:
    n = ds.num_nodes
    feats = torch.from_numpy(ds.features).to(dev)
    rows = []

    def rec(name, timed, detail=""):
        ms, launches = timed
        rows.append({"op": name, "ms": ms, "detail": detail,
                     "launches": launches})
        log(f"{name:44s} {ms:12.6f} ms  {detail}")

    for dtype in ("float32", "bfloat16"):
        mcfg, params, _, hop, batches, labels = bench._setup(
            ds, pad, dtype, B, 1, HIDDEN, dev, feats=feats)
        cache = cached.refresh_leaf_cache(hop, feats, FANOUT)
        programs = step_programs(mcfg, params, feats, *cache, hop,
                                 batches[0], labels[0])
        for op, program in (("refresh_leaf_cache", "refresh"),
                            ("full_step", "full_step"),
                            ("forward_only", "forward_only"),
                            ("fwd_bwd", "fwd_bwd"),
                            ("layer1_fulltable_gemm", "gemm")):
            rec(f"{op}_{dtype}", dev_time(programs[program], dev))
        del programs, cache
    rec("sampling_L-1_hops",
        dev_time(sampling_program(mcfg, hop, batches[0]), dev))

    m = B * (FANOUT + 1)
    ids = torch.from_numpy(uniform_ids(n, m)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        programs = movement_programs(
            torch.zeros(n, HIDDEN, dtype=dtype, device=dev), ids,
            torch.ones(m, HIDDEN, dtype=dtype, device=dev))
        for op, what in (("gather", "the gather_rows kernel"),
                         ("scatter_add",
                          "scatter_rows into zeros, added to the table"
                          if dtype == torch.bfloat16
                          else "index_add_ into the table"),
                         ("sort_segsum", "torch.sort, the values in its "
                                         "order, index_add_ into zeros, "
                                         "added to the table")):
            timed = dev_time(programs[op], dev)
            rec(f"{op}_{m}x{HIDDEN}_{name}", timed,
                f"{m / timed[0] * 1000 / 1e6:.0f}M rows/s; {what}")
    device, power_limit = bench.card(dev)
    return {"device": device, "power_limit": power_limit,
            "methodology": METHODOLOGY, "rows": rows}


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.set_defaults(nodes=100_000, edges=1_000_000)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = synthetic_power_law(args.nodes, args.edges, num_feats=602,
                                   num_classes=16, seed=0)
    pad = ds.graph.to_padded_sampled(32, np.random.RandomState(99))
    record = run(ds, pad, dev,
                 log=lambda *a: print(*a, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(record["rows"][-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
