"""The serving suite on the card: the port of the JAX system's
``tools/infer_bench.py``.

Row for row the same graphs, widths, dtypes and aggregators
(:func:`_row_specs`), each row one call of the port's shipped serving path,
``infer.full_graph_embeddings`` with the result kept on the card, for a
2-layer model of hidden 128 whose weights come from a torch.Generator
seeded 824:

- ``one_time_upload_s``: the params, features and adjacency placed on the
  card, synchronised;
- ``first_call_s``: the first call, synchronised; on a cold ``build/`` it
  includes the kernels' build, and ``kernel_build`` says whether the build
  ran in that call ("ran") or found current libraries ("reused");
- ``embed_all_ms``: the mean of ``REPS`` warm calls, each synchronised;
- ``result_pull_s``: the copy of the [N, 128] result to the host alone;
- ``launches``: the port's kernel launches of one call.

The cora and pubmed rows read the citation graphs under ``data/``; when
the file a graph cannot be loaded without is absent, the row is
``skipped`` and names it.  The 1,000,000-node row runs with
``--bigscale`` (its host generation takes about 100 s).  A row that fails
is an ``error`` row and the exit code is 1.  The rows go to ``INFER.json``
in the output directory.

    python -m graphsage_torch.infer_bench [--bigscale] [--out DIR]
    python -m graphsage_torch.infer_bench --device cpu

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from graphsage_torch.bench import DEFAULT_OUT, card, missing_data, sync
from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import (PaddedAdjacency, load_cora, load_pubmed,
                                  synthetic_power_law)
from graphsage_torch.infer import _resolve_device, full_graph_embeddings
from graphsage_torch.models import GraphSageConfig, init_graphsage
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import build

REPS = 5
PARAM_SEED = 824


def _row_specs(bigscale: bool = False) -> list[dict]:
    """The rows in execution order; ``width`` None serves the full
    adjacency, else a sampled table of that width (RandomState(99))."""
    specs = [
        {"name": "cora_full_adj_f32", "dataset": "cora", "width": None,
         "dtype": "float32", "agg": "MEAN",
         "note": "full adjacency (max-degree table): exact serving"},
        {"name": "pubmed_full_adj_bf16", "dataset": "pubmed", "width": None,
         "dtype": "bfloat16", "agg": "MEAN",
         "note": "full adjacency: exact serving on the real citation graph"},
        {"name": "powerlaw100k_cap32_bf16", "dataset": "powerlaw100k",
         "width": 32, "dtype": "bfloat16", "agg": "MEAN",
         "note": ("width-32 capped table (documented truncated serving "
                  "mode for power-law degrees); edge_slots_per_sec counts "
                  "both layers' aggregations")},
        {"name": "powerlaw100k_cap32_bf16_max", "dataset": "powerlaw100k",
         "width": 32, "dtype": "bfloat16", "agg": "MAX", "note": None},
    ]
    if bigscale:
        specs.append({"name": "powerlaw1M_cap16_bf16",
                      "dataset": "powerlaw1M", "width": 16,
                      "dtype": "bfloat16", "agg": "MEAN",
                      "note": "10M-edge config-5 scale, width-16 table"})
    return specs


def _load(dataset: str):
    if dataset == "cora":
        return load_cora()
    if dataset == "pubmed":
        return load_pubmed()
    if dataset == "powerlaw100k":
        return synthetic_power_law(100_000, 1_000_000, num_feats=602,
                                   num_classes=16, seed=0)
    if dataset == "powerlaw1M":
        return synthetic_power_law(1_000_000, 10_000_000, num_feats=602,
                                   num_classes=16, seed=0)
    raise ValueError(dataset)


def padded(ds, width: int | None):
    if width is None:
        return ds.graph.to_padded()
    return ds.graph.to_padded_sampled(width, np.random.RandomState(99))


def serve_row(name: str, ds, pad, dtype: str, agg_func: str,
              note: str | None = None, device=None):
    """One serving row: (row, the [N, 128] float32 embeddings on the host)."""
    dev = _resolve_device(device)
    cfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                          out_size=128, agg_func=agg_func,
                          compute_dtype=dtype)
    params = init_graphsage(torch.Generator().manual_seed(PARAM_SEED), cfg)
    kernel_build = None
    if dev.type == "cuda":
        kernel_build = ("reused" if all(build.library_path(s).exists()
                                        for s in build.SOURCES) else "ran")
    sync(dev)
    t0 = time.perf_counter()
    params = params_from_jax(params, dev)
    feats = torch.from_numpy(ds.features).to(dev)
    dpad = PaddedAdjacency(neighbors=torch.from_numpy(pad.neighbors).to(dev),
                           degrees=torch.from_numpy(pad.degrees).to(dev),
                           true_degrees=pad.true_degrees,
                           truncated=pad.truncated)
    sync(dev)
    upload_s = time.perf_counter() - t0

    def embed():
        return full_graph_embeddings(params, cfg, feats, dpad, fetch=False,
                                     device=dev)

    t0 = time.perf_counter()
    embed()
    sync(dev)
    first_s = time.perf_counter() - t0
    total = 0.0
    for rep in range(REPS):
        if rep == 0:
            agg.reset_launches()
        t0 = time.perf_counter()
        out = embed()
        sync(dev)
        total += time.perf_counter() - t0
        if rep == 0:
            launches = dict(agg.LAUNCHES)
    dt = total / REPS
    t0 = time.perf_counter()
    emb = out.float().cpu().numpy()
    pull_s = time.perf_counter() - t0
    if not np.isfinite(emb).all():
        raise FloatingPointError(f"{name}: non-finite embeddings")

    n = pad.num_nodes
    slots = float(pad.degrees.sum())
    device_name, power_limit = card(dev)
    row = {
        "name": name, "dtype": dtype, "agg": agg_func,
        "nodes": n, "table_width": pad.width,
        "edge_slots": int(slots),
        "embed_all_ms": dt * 1e3,
        "nodes_per_sec": n / dt,
        "edge_slots_per_sec": slots * cfg.num_layers / dt,
        "first_call_s": first_s,
        "one_time_upload_s": upload_s,
        "result_pull_s": pull_s,
        "device": device_name,
    }
    if note:
        row["note"] = note
    row.update(power_limit=power_limit, launches=launches,
               kernel_build=kernel_build)
    return row, emb


def run_suite(dev: torch.device, bigscale: bool = False,
              out: str = DEFAULT_OUT) -> int:
    """Every row in order; writes INFER.json into ``out``.  Returns 1 when
    a row errored, else 0."""
    rows, loaded = [], {}
    for spec in _row_specs(bigscale):
        missing = missing_data(spec["dataset"])
        if missing:
            row = {"name": spec["name"],
                   "skipped": f"dataset file absent: {missing}",
                   "missing": missing}
        else:
            try:
                if spec["dataset"] not in loaded:
                    loaded.clear()
                    loaded[spec["dataset"]] = _load(spec["dataset"])
                ds = loaded[spec["dataset"]]
                row, _ = serve_row(spec["name"], ds,
                                   padded(ds, spec["width"]), spec["dtype"],
                                   spec["agg"], spec["note"], dev)
            except Exception as e:  # noqa: BLE001 — every row is recorded
                traceback.print_exc()
                row = {"name": spec["name"],
                       "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print("#", json.dumps(row), flush=True)
    device_name, power_limit = card(dev)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "INFER.json")
    with open(path, "w") as f:
        json.dump({"rows": rows, "reps": REPS, "device": device_name,
                   "power_limit": power_limit,
                   "note": ("embed_all_ms: the mean of REPS synchronised "
                            "calls, the result kept on the card; uploads "
                            "and the result pull are one-time serving "
                            "costs, reported per row")}, f, indent=1)
    print(f"wrote {path} ({len(rows)} rows)", flush=True)
    return 1 if any("error" in r for r in rows) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bigscale", action="store_true",
                    help="also serve the 1,000,000-node graph")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory of INFER.json")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return run_suite(dev, args.bigscale, args.out)


if __name__ == "__main__":
    sys.exit(main())
