"""The cached supervised step, slice by slice, on the card: the port of the
JAX system's ``tools/step_anatomy.py``.

On the bench's setup (``bench._setup``: params seeded 824, the hop sampler
825, the batch ``RandomState(0)``) and one leaf-cache refresh, each slice
runs one warm call, then ``REPS`` calls between two synchronisations
(``profile_bigscale.timed_ms``); its time is ms a call.  Every call does
the slice's whole work: eager PyTorch hoists nothing out of a loop, so the
JAX tool's checksum carry and perturbations have no counterpart.  Slices:

- ``timing_floor``: an empty body, the loop's own cost;
- ``sampling``: the frontier draw of depths 0..L-2 at the batch;
- ``l1_gemm``: layer 1 over the full table (``sage_layer_apply`` on the
  params and tables cast to the compute dtype once, outside);
- ``l1_gemm_plus_gather``: the same, then the ``gather_rows`` kernel of the
  frontier's rows (``h1_gather_ms`` is the difference);
- ``fwd``: sampling, ``cached_forward``, the classifier and the loss,
  without a gradient;
- ``fwd_bwd``: the same and the gradient of every param (the bfloat16
  backward of the row gather is ``scatter_rows``);
- ``step``: ``cached.CachedStep``, the step with the clip and SGD;
- ``scatter_bound``: the backward of the frontier's row gather alone, an
  M-row [H] scatter into [N, H] as the step launches it (bfloat16
  ``scatter_rows``, float32 ``index_add_``);
- ``gather_bound``: the frontier's row gather alone, from [N, H].

The derived slices are the JAX tool's formulas.  Beside its keys a row
records each slice's kernel launches over its timed calls and, for the
step, the device's busy time by kernel and its idle share
(``profile_bigscale.device_busy``).  Workloads: ``100k`` (the bench's
headline graph: 100,000 nodes, 602 features, 16 classes), ``1m``
(config 5: ``bigscale_bench.load_1m``, the table drawn on the card) and
``tiny`` (2,000 nodes, 32 features).  Rows merge into
``PROFILE_ANATOMY.json`` in the output directory by (workload, batch,
mode), fresh rows winning.

    python -m graphsage_torch.step_anatomy [100k|1m|tiny] [batch ...]
    python -m graphsage_torch.step_anatomy tiny 64 --device cpu

Without a card it raises unless ``--device cpu`` is given.  ``--nodes``
and ``--edges`` shrink the ``1m`` graph for tests and CPU drives only.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import (common_args, device_feats,
                                            load_1m, setup_device,
                                            write_merged)
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models.layers import classifier_apply, sage_layer_apply
from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.ops.scatter import scatter_rows
from graphsage_torch.profile_bigscale import device_busy, timed_ms
from graphsage_torch.train import cached
from graphsage_torch.train.dense import cast_compute
from graphsage_torch.train.optim import tree_leaves

REPS = 20
OUT_FILE = "PROFILE_ANATOMY.json"
SLICES = ("timing_floor", "sampling", "l1_gemm", "l1_gemm_plus_gather",
          "fwd", "fwd_bwd", "step", "scatter_bound", "gather_bound")
NOTE = ("cached sup step per-slice anatomy; a warm call, then REPS calls "
        "between two synchronisations (timing_floor_ms is the empty "
        "loop's).  Derived slices subtract measured sub-programs.")


def slice_programs(mcfg, params: dict, feats, cache_feats, cache_count, hop,
                   batch_ids, labels, ids, table, dout,
                   fanout: int = 10) -> dict:
    """Each slice's program, by name (``SLICES``): a call with no arguments
    that does the slice's work once and returns its result.  ``ids`` is
    one draw of the frontier's bottom rows; ``table`` [N, H] and ``dout``
    [M, H] are the bound slices' operands."""
    w1 = cast_compute(params["sage"]["layers"][0], mcfg)
    cfeats = cast_compute(feats, mcfg)
    ccache = cast_compute(cache_feats, mcfg)
    n = feats.shape[0]
    step = cached.CachedStep(mcfg, fanout=fanout)
    ones = torch.ones(batch_ids.shape[0], device=batch_ids.device)

    def loss_of(p):
        sampled = cached.sample_cached_frontiers(hop, batch_ids, mcfg, fanout)
        embs = cached.cached_forward(p, mcfg, feats, cache_feats,
                                     cache_count, *sampled, fanout)
        return supervised_nll(
            classifier_apply(cast_compute(p["clf"], mcfg), embs), labels,
            ones)

    @torch.no_grad()
    def l1_gemm():
        return sage_layer_apply(w1, cfeats, ccache, gcn=False)

    def fwd_bwd():
        loss = loss_of(params)
        leaves = tree_leaves(params)
        return loss.detach(), torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)

    return {
        "timing_floor": lambda: None,
        "sampling": lambda: cached.sample_cached_frontiers(
            hop, batch_ids, mcfg, fanout),
        "l1_gemm": l1_gemm,
        "l1_gemm_plus_gather": lambda: gather_rows(l1_gemm(), ids),
        "fwd": torch.no_grad()(lambda: loss_of(params)),
        "fwd_bwd": fwd_bwd,
        "step": lambda: step(params, feats, cache_feats, cache_count, hop,
                             batch_ids, labels),
        "scatter_bound": lambda: scatter_rows(dout, ids, n),
        "gather_bound": lambda: gather_rows(table, ids),
    }


def derived(res: dict) -> dict:
    """The JAX tool's derived slices (``tools/step_anatomy.py:252-260``).
    Every measured slice carries the floor once: fwd - l1pg - samp nets to
    minus one floor, so one is added back."""
    return {
        "upper_plus_head_fwd_ms": (res["fwd_ms"] - res["l1_gemm_plus_gather_ms"]
                                   - res["sampling_ms"]
                                   + res["timing_floor_ms"]),
        "backward_ms": res["fwd_bwd_ms"] - res["fwd_ms"],
        "opt_ms": res["step_ms"] - res["fwd_bwd_ms"],
    }


def anatomy(ds, pad, batch: int, dev: torch.device, dtype: str = "bfloat16",
            hidden: int = 128, fanout: int = 10, feats=None,
            log=print, keep: dict | None = None) -> dict:
    """The anatomy of the step at ``batch`` (``feats``: a table already on
    ``dev``, as ``bench._setup`` takes it).  A ``keep`` dict receives the
    frontier's ids that the bound slices ran on, as ``keep["ids"]``."""
    mcfg, params, feats, hop, batches, labels = bench._setup(
        ds, pad, dtype, batch, 1, hidden, dev, feats=feats)
    cache = cached.refresh_leaf_cache(hop, feats, fanout)
    ids, _ = cached.sample_cached_frontiers(hop, batches[0], mcfg, fanout)
    if keep is not None:
        keep["ids"] = ids
    n = feats.shape[0]
    cdtype = getattr(torch, dtype)
    programs = slice_programs(
        mcfg, params, feats, *cache, hop, batches[0], labels[0], ids,
        torch.zeros(n, hidden, dtype=cdtype, device=dev),
        torch.ones(ids.shape[0], hidden, dtype=cdtype, device=dev), fanout)
    res = {"batch": batch, "nodes": n, "frontier_rows": batch * (fanout + 1),
           "dtype": dtype}
    launches = {}
    for name in SLICES:
        res[f"{name}_ms"], launches[name] = timed_ms(programs[name], dev,
                                                     REPS)
        log(f"# slice {name}_ms: {res[f'{name}_ms']:.6f}")
    res["h1_gather_ms"] = res["l1_gemm_plus_gather_ms"] - res["l1_gemm_ms"]
    m = ids.shape[0]
    res["scatter_rows_per_sec"] = m / (res["scatter_bound_ms"] / 1e3)
    res["gather_rows_per_sec"] = m / (res["gather_bound_ms"] / 1e3)
    res.update(derived(res))
    res["launches"] = launches

    def steps():
        for _ in range(REPS):
            programs["step"]()

    _, busy, kernels = device_busy(steps, dev)
    wall = res["step_ms"] * REPS
    res["step_profile"] = {
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": None if busy is None else 1 - busy / wall,
        "by_kernel": [{"kernel": k[:120], "ms": ms, "launches": c}
                      for k, ms, c in kernels]}
    return res


def load(which: str, nodes: int, edges: int, dev: torch.device):
    """(dataset, its sampled table, the feature table on ``dev`` or None
    for ``bench._setup`` to upload) of a workload."""
    if which == "tiny":
        ds = synthetic_power_law(2000, 10000, num_feats=32, num_classes=4,
                                 seed=0)
        return ds, ds.graph.to_padded_sampled(
            16, np.random.RandomState(99)), None
    if which == "1m":
        ds, pad, _ = load_1m(nodes, edges)
        return ds, pad, device_feats(ds.num_nodes, ds.feature_dim, dev)
    ds = synthetic_power_law(100_000, 1_000_000, num_feats=602,
                             num_classes=16, seed=0)
    return ds, ds.graph.to_padded_sampled(32,
                                          np.random.RandomState(99)), None


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default="100k",
                    choices=("100k", "1m", "tiny"))
    ap.add_argument("batches", nargs="*", type=int, default=[65536])
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    t0 = time.time()
    ds, pad, feats = load(args.workload, args.nodes, args.edges, dev)
    log(f"# setup {time.time() - t0:.0f}s")
    device, power_limit = bench.card(dev)
    rows = []
    for b in args.batches:
        row = anatomy(ds, pad, b, dev, feats=feats, log=log)
        row.update(workload=args.workload, device=device,
                   power_limit=power_limit)
        rows.append(row)
        log("#", json.dumps(row))
    path = write_merged({"note": NOTE, "rows": rows}, args.out, OUT_FILE,
                        key=lambda r: (r.get("workload"), r.get("batch"),
                                       r.get("mode")))
    log(f"# wrote {path}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
