"""Config 5 on one card: the port of the JAX system's
``tools/bigscale_bench.py``.

BASELINE.json's config 5 is a synthetic power-law graph of 1,000,000 nodes
and 10,000,000 edges.  On it, with 602 features, hidden 128, fanout 10, a
width-32 sampled table (``to_padded_sampled(32, RandomState(99))``) and
bfloat16 tables, this times the leaf-cached training rows with the honest
epoch length T = ceil(train_split / B), train_split = N // 2:

- per batch size (65536: T 8; 131072: T 4), the refresh alone (median of
  3 after a warm call), the step alone (``cached.cached_epoch_reuse`` on a
  held cache) and the fused epoch (``bench.cached_epoch``, the refresh
  inside), each epoch timed by ``bench._timed``; the fused epoch's row is
  ``powerlaw1M_b{B}_cached_bfloat16`` with the staleness composite
  edges/s at refresh_every = k for k in 1, 2, 4, 8:
  edges_per_batch / (step_only + refresh / (k·T));
- ``direct``: the real refresh-then-k-reuse-epochs cycle at B 131072, for
  k 4 and 8, 3 reps, one synchronisation at the end of each;
- ``unsup``: ``bench.run_unsup_row`` at B 32768, T 16.

The [N, 602] feature table is drawn on the card in bfloat16 from a
``torch.Generator`` seeded 1 (times 0.1) and never uploaded: its content
does not change the step's cost.  The params, the hop sampler and the
batch stack come from ``bench._setup`` (seeds 824 / 825,
``RandomState(0)`` batches).  Beside the JAX tool's keys each row records
the card, its power limit, the kernel launches of one timed epoch and the
peak of ``torch.cuda.max_memory_allocated`` over the row (with its share
of the card's memory).  ``dispatch_fetch_rtt_ms`` is a one-element add and
its fetch to the host, median of 7: what every timed rep pays once.

Generating the graph takes about 100 s of host time.  Rows are chosen with
``--rows`` (default ``65536,131072,unsup``; add ``direct``); they are
merged into ``BIGSCALE.json`` in the output directory, fresh rows winning.

    python -m graphsage_torch.bigscale_bench [--rows R] [--out DIR]
    python -m graphsage_torch.bigscale_bench --device cpu --nodes 2000 \\
        --edges 10000              # a small drive on the plain versions

Without a card it raises unless ``--device cpu`` is given.  ``--nodes``
and ``--edges`` shrink the graph for tests and CPU drives only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.infer import _resolve_device
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.train import cached, dense
from graphsage_torch.train.trainer import _leaf_params

NODES, EDGES, FEATS, CLASSES = 1_000_000, 10_000_000, 602, 16
WIDTH, HIDDEN, FANOUT, DTYPE = 32, 128, 10, "bfloat16"
SUP_BATCHES, UNSUP_BATCH = (65536, 131072), 32768
DIRECT_BATCH, DIRECT_KS, DIRECT_REPS = 131072, (4, 8), 3
STALENESS_KS = (1, 2, 4, 8)
DEFAULT_ROWS = "65536,131072,unsup"
FEATS_SEED = 1
OUT_FILE = "BIGSCALE.json"


def load_1m(nodes: int = NODES, edges: int = EDGES):
    """(dataset, its width-32 sampled table, host seconds): config 5's
    graph, ``synthetic_power_law(nodes, edges, seed=0)`` with 602 features
    and 16 classes."""
    t0 = time.time()
    ds = synthetic_power_law(nodes, edges, num_feats=FEATS,
                             num_classes=CLASSES, seed=0)
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    return ds, pad, time.time() - t0


def device_feats(n: int, d: int, dev: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The [n, d] feature table drawn on ``dev`` in ``dtype``: 0.1 times a
    standard normal from a torch.Generator seeded FEATS_SEED."""
    gen = torch.Generator(device=dev).manual_seed(FEATS_SEED)
    return torch.randn((n, d), generator=gen, dtype=dtype, device=dev) * 0.1


def honest_steps(train_split: int, batch: int) -> int:
    """T = ceil(train_split / B): one epoch visits the train split once."""
    return -(-train_split // batch)


def staleness_edges_per_sec(edges: float, dt_step: float, refresh_ms: float,
                            steps: int) -> dict:
    """edges/s at refresh_every = k: one batch's edges over a step plus the
    refresh amortised over k epochs of T steps."""
    return {f"k{k}": edges / (dt_step + refresh_ms / 1e3 / (k * steps))
            for k in STALENESS_KS}


def steponly_epoch(mcfg, fanout: int = FANOUT):
    """``epoch(params, feats, cache_feats, cache_count, hop, batches,
    labels) -> losses [T]``: the T steps on a held cache."""
    step = cached.CachedStep(mcfg, fanout=fanout)

    def epoch(params, feats, cache_feats, cache_count, hop, batches, labels):
        return cached.cached_epoch_reuse(step, params, feats, cache_feats,
                                         cache_count, hop, batches, labels)

    return epoch


def k_cycle(mcfg, fanout: int = FANOUT):
    """``cycle(params, feats, hop, batches, labels, k) -> losses [T]`` of
    its last epoch: one refresh, then k epochs on its cache."""
    epoch = steponly_epoch(mcfg, fanout)

    def cycle(params, feats, hop, batches, labels, k):
        cache = cached.refresh_leaf_cache(hop, feats, fanout)
        for _ in range(k):
            losses = epoch(params, feats, *cache, hop, batches, labels)
        return losses

    return cycle


def card_memory(dev: torch.device) -> dict:
    """The peak of max_memory_allocated since the last reset, and its share
    of the card's memory; nulls on the CPU."""
    if dev.type != "cuda":
        return {"peak_mem_bytes": None, "peak_mem_share": None}
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    return {"peak_mem_bytes": peak, "peak_mem_share": peak / total}


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def refresh_alone_ms(hop, feats, dev: torch.device, reps: int = 3):
    """The refresh alone: one warm call, then the median of ``reps``
    calls, each between two synchronisations.  Returns (ms, the last
    cache)."""
    cache = cached.refresh_leaf_cache(hop, feats, FANOUT)
    times = []
    for _ in range(reps):
        bench.sync(dev)
        t0 = time.perf_counter()
        cache = cached.refresh_leaf_cache(hop, feats, FANOUT)
        bench.sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, cache


def dispatch_fetch_rtt_ms(dev: torch.device) -> float:
    """A one-element add on ``dev`` and its fetch to the host: the median
    of 7 after a warm one."""
    x = torch.zeros((), device=dev)
    (x + 1.0).item()
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        (x + 1.0).item()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def sup_row(ds, pad, feats, batch: int, train_split: int,
            dev: torch.device, refresh_ms: float | None = None):
    """One batch size's row.  ``refresh_ms`` None measures the refresh
    alone here (the JAX tool measures it at the first batch size and
    composes every row with it).  Returns (row, refresh_ms)."""
    steps = honest_steps(train_split, batch)
    reset_peak(dev)
    mcfg, params, feats, hop, batches, labels = bench._setup(
        ds, pad, DTYPE, batch, steps, HIDDEN, dev, feats=feats)
    if refresh_ms is None:
        refresh_ms, cache = refresh_alone_ms(hop, feats, dev)
    else:
        cache = cached.refresh_leaf_cache(hop, feats, FANOUT)
    dt_step, reps_step, launches_step = bench._timed(
        steponly_epoch(mcfg), (params, feats, *cache, hop, batches, labels),
        steps, dev)
    del cache
    dt_fused, reps_fused, launches = bench._timed(
        bench.cached_epoch(mcfg, FANOUT), (params, feats, hop, batches,
                                           labels), steps, dev)
    row = bench._row_from_dt(f"powerlaw1M_b{batch}_cached_{DTYPE}",
                             "cached", DTYPE, batch, ds, pad, dt_fused,
                             reps_fused, launches, FANOUT, HIDDEN, dev)
    edges = dense.edges_per_batch(batch, 2, FANOUT)
    row.update({
        "honest_T": steps,
        "steponly_ms": dt_step * 1e3,
        "steponly_rep_ms": [r * 1e3 for r in reps_step],
        "steponly_launches": launches_step,
        "refresh_ms_per_epoch": refresh_ms,
        "staleness_edges_per_sec": staleness_edges_per_sec(
            edges, dt_step, refresh_ms, steps),
        **card_memory(dev),
    })
    return row, refresh_ms


def direct_rows(ds, pad, feats, train_split: int, dev: torch.device,
                batch: int) -> list:
    """The refresh_every = k cycle timed whole: a refresh and k epochs on
    its cache from the same initial params each rep, one synchronisation
    at the end; a warm refresh and epoch first."""
    steps = honest_steps(train_split, batch)
    device, power_limit = bench.card(dev)
    reset_peak(dev)
    mcfg, params, feats, hop, batches, labels = bench._setup(
        ds, pad, DTYPE, batch, steps, HIDDEN, dev, feats=feats)
    cycle = k_cycle(mcfg)
    cycle(_leaf_params(params, dev), feats, hop, batches, labels, 1)
    rows = []
    for k in DIRECT_KS:
        reps, launches = [], None
        for r in range(DIRECT_REPS):
            p = _leaf_params(params, dev)
            bench.sync(dev)
            agg.reset_launches()
            t0 = time.perf_counter()
            losses = cycle(p, feats, hop, batches, labels, k)
            bench.sync(dev)
            reps.append(time.perf_counter() - t0)
            if r == 0:
                launches = dict(agg.LAUNCHES)
        if not bool(torch.isfinite(losses).all()):
            raise FloatingPointError(f"non-finite losses in the k={k} "
                                     f"cycle: {losses.tolist()}")
        wall = float(np.median(reps))
        edges_cycle = k * steps * dense.edges_per_batch(batch, 2, FANOUT)
        rows.append({
            "name": f"powerlaw1M_b{batch}_cached_{DTYPE}_direct_k{k}",
            "pipeline": "cached", "dtype": DTYPE, "agg": "MEAN",
            "batch": batch, "nodes": ds.num_nodes,
            "refresh_every": k, "honest_T": steps,
            "cycle_wall_s": wall, "cycle_rep_s": reps,
            "edges_per_sec": edges_cycle / wall,
            "note": ("the refresh_every=k cycle measured whole: a refresh "
                     "and k reuse epochs in one window, one "
                     "synchronisation at its end; it checks the composed "
                     "staleness_edges_per_sec column"),
            "device": device, "power_limit": power_limit,
            "launches": launches, **card_memory(dev)})
    return rows


def unsup_row(ds, pad, feats, train_split: int, dev: torch.device,
              batch: int) -> dict:
    reset_peak(dev)
    row = bench.run_unsup_row(f"powerlaw1M_b{batch}_cached_{DTYPE}_unsup",
                              ds, pad, batch, DTYPE,
                              steps=honest_steps(train_split, batch),
                              device=dev, feats=feats)
    row.update(card_memory(dev))
    return row


def run(ds, pad, feats, rows: set, dev: torch.device, gen_s: float,
        log=print) -> dict:
    """The rows of ``rows`` (of 65536, 131072, direct, unsup) on the loaded
    graph and the feature table ``feats`` on ``dev``; the record."""
    train_split = ds.num_nodes // 2
    rtt_ms = dispatch_fetch_rtt_ms(dev)
    log(f"# dispatch+fetch round trip: {rtt_ms:.6f} ms")
    out_rows, refresh_ms = [], None
    for batch in SUP_BATCHES:
        if str(batch) not in rows:
            continue
        row, refresh_ms = sup_row(ds, pad, feats, batch, train_split, dev,
                                  refresh_ms)
        out_rows.append(row)
        log("#", json.dumps(row))
    if "direct" in rows:
        for row in direct_rows(ds, pad, feats, train_split, dev,
                               DIRECT_BATCH):
            out_rows.append(row)
            log("#", json.dumps(row))
    if "unsup" in rows:
        out_rows.append(unsup_row(ds, pad, feats, train_split, dev,
                                  UNSUP_BATCH))
        log("#", json.dumps(out_rows[-1]))
    device, power_limit = bench.card(dev)
    return {
        "dispatch_fetch_rtt_ms": rtt_ms,
        "workload": {"nodes": ds.num_nodes,
                     "edge_slots": int(pad.true_degrees.sum()),
                     "feat_dim": feats.shape[1], "hidden": HIDDEN,
                     "fanout": FANOUT, "train_split": train_split},
        "host_generation_s": gen_s,
        "device": device, "power_limit": power_limit,
        "note": ("BASELINE config-5 scale on one card, honest epochs: T = "
                 "ceil(train_split/B), the refresh timed apart from the "
                 "step; staleness_edges_per_sec composes step-only + "
                 "refresh/k for refresh_every=k; the direct_k rows time "
                 "the k-cycle whole"),
        "rows": out_rows,
    }


def write_merged(record: dict, out_dir: str, name: str = OUT_FILE,
                 key=lambda row: row.get("name")) -> str:
    """``record`` into ``out_dir/name``, after the rows of an earlier file
    there that this run did not measure, a row known by ``key(row)``
    (fresh rows win)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        have = {key(r) for r in record["rows"]}
        record = dict(record, rows=record["rows"] + [
            r for r in old.get("rows", []) if key(r) not in have])
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def common_args(description: str) -> argparse.ArgumentParser:
    """The flags the config-5 modules share."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=bench.DEFAULT_OUT,
                    help="directory of the output files")
    ap.add_argument("--nodes", type=int, default=NODES,
                    help="graph nodes (tests and CPU drives only)")
    ap.add_argument("--edges", type=int, default=EDGES,
                    help="graph edges (tests and CPU drives only)")
    return ap


def setup_device(name: str | None) -> torch.device:
    dev = _resolve_device(name)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default=DEFAULT_ROWS,
                    help="comma list of 65536, 131072, unsup, direct")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds, pad, gen_s = load_1m(args.nodes, args.edges)
    print(f"# generated {ds.num_nodes} nodes / "
          f"{int(pad.true_degrees.sum())} edge slots in {gen_s:.1f} s",
          file=sys.stderr, flush=True)
    feats = device_feats(ds.num_nodes, ds.feature_dim, dev)
    record = run(ds, pad, feats, set(args.rows.split(",")), dev, gen_s,
                 log=lambda *a: print(*a, file=sys.stderr, flush=True))
    path = write_merged(record, args.out)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(record["rows"][0] if record["rows"] else {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
