"""The host cost of exact negatives at 100,000 nodes / 1,000,000 edges: the
port of the JAX system's ``tools/pairs_scale_bench.py``.

The unsup bench rows draw synthetic pair tensors; this measures the real
``PairSampler.sample_batch`` wall at the power-law workload where "auto"
picks exact BFS closures (the semantics of the original GraphSAGE
implementation's ``models.py``, lines 153-167):

- the per-root closure cost, the lazy per-root path against the batched
  C++ thread-pool builder (``native.far_lists_native``,
  ``csrc/gs_native.cpp::gs_far_lists``, the port's own build);
- the FULL first epoch at b 4096 (every train node's closure built once:
  the cost the LRU cache then amortises for the rest of the process);
- the warm ``sample_batch`` (the per-step host cost that prefetch overlaps
  with device work);
- uniform mode for comparison, and the data behind the auto exact/uniform
  rule.

Host work only: nothing runs on a device, so the module takes no
``--device``.  The first epoch scales with 1/cores through the C++ thread
pool.  Roots and batches draw from ``RandomState(0)``, the epoch's order
from ``RandomState(1)``, as in the JAX tool; its ``auto`` must pick exact
(``GS_EXACT_NEG_BUDGET_S`` at its default).  Writes ``PAIRS_SCALE.json``
in the output directory.

    python -m graphsage_torch.pairs_scale_bench [--out DIR]

``--nodes`` and ``--edges`` shrink the graph for tests and CPU drives
only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from graphsage_torch import bench
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.native import far_lists_native
from graphsage_torch.sampler.pairs import PairSampler

NODES, EDGES, B, NUM_NEG = 100_000, 1_000_000, 4096, 100
OUT_FILE = "PAIRS_SCALE.json"


def _count(n: int) -> str:
    """100000 -> "100k", 1000000 -> "1M"."""
    if n % 1_000_000 == 0:
        return f"{n // 1_000_000}M"
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def run(ds, edges: int = EDGES, log=print) -> dict:
    """The record, on ``ds``'s graph (drawn with ``edges`` edges) and train
    split."""
    g = ds.graph
    train = ds.train_nodes
    rng = np.random.RandomState(0)
    out = {
        "workload": f"powerlaw {_count(ds.num_nodes)} nodes / "
                    f"{_count(edges)} edges "
                    f"({len(g.indices)} directed slots), "
                    f"{len(train)} train nodes",
        "host_cores": os.cpu_count(),
        "num_neg": NUM_NEG,  # reference normal-loss count (src/utils.py:119)
    }

    # --- per-root: lazy path (bfs_closure_native + numpy postprocess) ----
    ps_lazy = PairSampler(g, train, negative_mode="exact")
    roots = rng.choice(train, 128, replace=False)
    t0 = time.perf_counter()
    for r in roots:
        ps_lazy._far_nodes(int(r))
    out["per_root_lazy_ms"] = round(
        (time.perf_counter() - t0) / len(roots) * 1e3, 2)

    # --- per-root: batched C++ thread pool ------------------------------
    roots2 = rng.choice(train, 1024, replace=False).astype(np.int32)
    t0 = time.perf_counter()
    far = far_lists_native(g.indptr, g.indices, g.num_nodes, roots2, 5,
                           train)
    dt = time.perf_counter() - t0
    out["per_root_batched_ms"] = round(dt / len(roots2) * 1e3, 2)
    out["edge_visit_rate_per_s"] = round(len(roots2) * len(g.indices) / dt)
    sizes = [len(f) for f in far]
    out["far_list_sizes"] = {"min": int(np.min(sizes)),
                             "median": int(np.median(sizes)),
                             "max": int(np.max(sizes))}
    log("#", json.dumps(out))

    # --- FULL first epoch: every train closure once via sample_batch ----
    ps = PairSampler(g, train)  # auto -> exact at this scale
    assert ps.negative_mode == "exact", ps.negative_mode
    order = np.random.RandomState(1).permutation(train)
    step_ms = []
    t_epoch = time.perf_counter()
    for lo in range(0, len(order), B):
        chunk = order[lo:lo + B]
        t0 = time.perf_counter()
        ps.sample_batch(chunk, num_neg=NUM_NEG, rng=rng)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["first_epoch_wall_s"] = round(time.perf_counter() - t_epoch, 1)
    out["first_epoch_steps"] = len(step_ms)
    out["first_epoch_ms_per_step_median"] = round(
        float(np.median(step_ms)), 1)
    out["far_cache_mb"] = round(ps._far_cache_bytes / 2**20, 1)
    log("#", json.dumps({k: out[k] for k in (
        "first_epoch_wall_s", "first_epoch_steps",
        "first_epoch_ms_per_step_median", "far_cache_mb")}))

    # --- steady state: warm cache ---------------------------------------
    warm_ms = []
    for lo in range(0, B * 8, B):
        chunk = order[lo:lo + B]
        t0 = time.perf_counter()
        ps.sample_batch(chunk, num_neg=NUM_NEG, rng=rng)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    out["steady_state_ms_per_batch_b4096"] = round(
        float(np.median(warm_ms)), 1)

    # --- uniform mode for comparison ------------------------------------
    ps_u = PairSampler(g, train, negative_mode="uniform")
    uni_ms = []
    for lo in range(0, B * 4, B):
        chunk = order[lo:lo + B]
        t0 = time.perf_counter()
        ps_u.sample_batch(chunk, num_neg=NUM_NEG, rng=rng)
        uni_ms.append((time.perf_counter() - t0) * 1e3)
    out["uniform_ms_per_batch_b4096"] = round(float(np.median(uni_ms)), 1)

    # --- the auto rule, restated against the measurement -----------------
    rate = 300e6 * max(1, os.cpu_count() or 1)
    out["auto_rule"] = {
        "rule": "exact iff n_train * directed_edge_slots / "
                "(300e6 * cores) <= GS_EXACT_NEG_BUDGET_S (default 180)",
        "this_workload_estimate_s": round(
            len(train) * len(g.indices) / rate, 1),
        "config5_1M_10M_estimate_s": round(500_000 * 18_500_000 / rate),
        "decision_here": ps.negative_mode,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=bench.DEFAULT_OUT,
                    help="directory of the output file")
    ap.add_argument("--nodes", type=int, default=NODES,
                    help="graph nodes (tests and CPU drives only)")
    ap.add_argument("--edges", type=int, default=EDGES,
                    help="graph edges (tests and CPU drives only)")
    args = ap.parse_args(argv)
    ds = synthetic_power_law(args.nodes, args.edges, num_feats=8,
                             num_classes=16, seed=0)
    out = run(ds, args.edges,
              log=lambda *a: print(*a, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
