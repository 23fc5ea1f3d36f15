"""The training suite on the card: the port of the JAX system's ``bench.py``.

Row for row it keeps that suite's registry (:func:`_row_specs`: nine rows,
headline first), its accounting (edges a batch from
``train.dense.edges_per_batch``, matmul FLOPs a step from
:func:`matmul_flops_per_step`) and the program it times:

- a cached row: one leaf-cache refresh, then the T steps of the epoch
  (``cached.refresh_leaf_cache``, then ``cached.cached_epoch_reuse`` over a
  ``CachedStep``), the refresh inside the timed epoch; an LSTM row runs the
  cached-LSTM hybrid; the unsup row takes the pair loss each step on
  synthesized pair tensors (:func:`unsup_pairs`);
- the dense row: ``dense.make_dense_sup_epoch``.

Each row times one warm epoch, then ``TIMED_REPS`` epochs, each between two
``torch.cuda.synchronize()``; ``step_ms`` is the median epoch over its
steps.  Beside the JAX suite's keys a row carries the card's power limit
(``nvidia-smi``), ``peak_tflops`` (the card's dense bfloat16 tensor-core
peak from :data:`PEAK_TFLOPS`; ``peak_tflops`` and ``mfu`` are null for a
card the table lacks) and ``launches``: the port's kernel launches over
one timed epoch, read from the wrappers' counters.  The JAX suite's
roofline columns are left out: their bounds are not this card's.

The suite runs each row once, in a child process (``--row NAME``), so a
CUDA fault in one row cannot poison the next row's context: headline
first, under a per-row timeout and the suite's budget
(``GS_BENCH_ROW_TIMEOUT_S``, default 240 s; ``GS_BENCH_SUITE_BUDGET_S``,
default 1200 s; ``GS_BENCH_INPROC=1`` runs the rows in this process).  A
row that fails is an ``error`` row and the exit code is 1; a row whose
dataset file is absent is a ``skipped`` row that names the file.  Rows
stream to ``BENCH_DETAIL.partial.json`` in the output directory, which is
promoted to ``BENCH_DETAIL.json`` when every row ran or was skipped for
its data.  The last line of the output is the summary, always printed.

    python -m graphsage_torch.bench [--out DIR]   # DIR: build/bench_torch
    python -m graphsage_torch.bench --device cpu  # the plain versions

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from graphsage_torch.data import (load_cora, load_pubmed,
                                  synthetic_power_law)
from graphsage_torch.data.loaders import _DATA_ROOT
from graphsage_torch.infer import _resolve_device
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.models.graphsage import compute_dtype
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import cached, dense
from graphsage_torch.train.trainer import _leaf_params

# the unmodified torch reference measured on a CPU host (BASELINE.md), not
# a number of any card: the rate each row's vs_reference divides by
REFERENCE_EDGES_PER_SEC = {"MEAN": 409_565.0, "MAX": 360_559.0}

# dense bfloat16 tensor-core peak by card (TFLOP/s): NVIDIA's data sheet,
# SXM part, without sparsity
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

HEADLINE_ROW = "powerlaw100k_b65536_cached_bfloat16"
TIMED_REPS = 3
PARAM_SEED, SAMPLER_SEED = 824, 825
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_ROOT, "build", "bench_torch")
# the file each citation graph cannot be loaded without (data/loaders.py)
_DATA_FILES = {"cora": ("cora", "cora.cites"),
               "pubmed": ("pubmed-data",
                          "Pubmed-Diabetes.DIRECTED.cites.tab")}


def matmul_flops_per_step(pipeline: str, n_nodes: int, feat_dim: int,
                          batch: int, fanout: int, hidden: int,
                          classes: int, agg: str = "MEAN") -> float:
    """Analytic matmul FLOPs of one train step (forward and the backward
    GEMMs autograd runs); gathers, reductions and sampling are not
    counted.  The cached layer-1 GEMM runs over the rows that
    ``cached.layer1_full_table`` picks: the full table or the frontier."""
    k1 = fanout + 1
    if pipeline == "cached":
        m1 = batch * k1
        full = cached.layer1_full_table(n_nodes, feat_dim, m1, hidden)
        rows1 = n_nodes if full else m1
        # the tables carry no gradient: layer 1's backward is dW only
        f = 2 * rows1 * (2 * feat_dim) * hidden * 2
        # layer 2 and the classifier: forward, dW and dx
        f += 2 * batch * (2 * hidden) * hidden * 3
        f += 2 * batch * hidden * classes * 3
        if agg == "LSTM":
            # the hybrid's layer-2 cell: x·w_ihᵀ + h·w_hhᵀ, 2·(2·H·4H)
            # FLOPs a row and slot, K+1 slots, forward and backward
            f += batch * k1 * 16 * hidden * hidden * 3
        return float(f)
    if pipeline == "dense":
        # the table pretransform, forward and dW (the table is constant)
        f = 2 * n_nodes * feat_dim * (2 * hidden) * 2
        f += 2 * batch * (2 * hidden) * hidden * 3
        f += 2 * batch * hidden * classes * 3
        return float(f)
    raise ValueError(pipeline)


# The rows in execution order: the headline first, pubmed and unsup next,
# the latency-bound cora row last (the JAX suite's registry, field for
# field).  "dataset" keys into _load_dataset.
_PL_ROWS = [
    ("cached", 65536, "bfloat16", "MEAN"),   # the headline
    ("cached", 32768, "bfloat16", "MEAN"),
    ("cached", 32768, "float32", "MEAN"),
    ("dense", 4096, "bfloat16", "MEAN"),
    ("cached", 32768, "bfloat16", "MAX"),
    ("cached", 32768, "bfloat16", "LSTM"),
]
# the per-row timeout of the MAX and LSTM rows (others: the default)
_SLOW_ROW_TIMEOUT_S = 420.0


def _row_specs():
    specs = []
    for pipeline, batch, dtype, agg_func in _PL_ROWS:
        suffix = ("" if agg_func == "MEAN" else
                  "_lstm_hybrid" if agg_func == "LSTM"
                  else f"_{agg_func.lower()}")
        note = ("cached-LSTM hybrid (train/cached.py): MEAN leaf cache, "
                "live LSTM cells at layer 2; reference has no LSTM — "
                "vs_reference uses the MEAN sup baseline"
                if agg_func == "LSTM" else None)
        spec = {
            "name": f"powerlaw100k_b{batch}_{pipeline}_{dtype}{suffix}",
            "dataset": "powerlaw", "kind": "sup", "pipeline": pipeline,
            "batch": batch, "dtype": dtype, "agg": agg_func, "steps": 20,
            "note": note}
        if agg_func in ("MAX", "LSTM"):
            spec["row_timeout_s"] = _SLOW_ROW_TIMEOUT_S
        specs.append(spec)
    specs.insert(1, {"name": "pubmed_b8192_cached_bfloat16",
                     "dataset": "pubmed", "kind": "sup",
                     "pipeline": "cached", "batch": 8192,
                     "dtype": "bfloat16", "steps": 20,
                     "note": ("real Pubmed citation graph (19717 nodes / "
                              "500 feats)")})
    specs.insert(2, {"name": "powerlaw100k_b32768_cached_bfloat16_unsup",
                     "dataset": "powerlaw", "kind": "unsup", "batch": 32768,
                     "dtype": "bfloat16"})
    specs.append({
        "name": "cora_b512_dense_f32", "dataset": "cora", "kind": "sup",
        "pipeline": "dense", "batch": 512, "dtype": "float32", "steps": 50,
        "note": ("latency-bound: the 2708-node graph cannot load the "
                 "chip; measures dispatch + small-kernel latency. "
                 "Neighbor cache width 32, refreshed once per 50-step "
                 "window (production refreshes per epoch; subset "
                 "composition keeps per-draw sampling exactly uniform "
                 "either way)")})
    return specs


def missing_data(dataset: str) -> str | None:
    """The absent file that ``dataset`` cannot be loaded without, or None
    (the synthetic graphs need no file)."""
    if dataset not in _DATA_FILES:
        return None
    path = os.path.join(_DATA_ROOT, *_DATA_FILES[dataset])
    return None if os.path.exists(path) else path


def _load_dataset(tag: str):
    if tag == "cora":
        ds = load_cora()
        pad = ds.graph.to_padded().subsample(32, np.random.RandomState(99))
    elif tag == "pubmed":
        ds = load_pubmed()
        pad = ds.graph.to_padded().subsample(32, np.random.RandomState(99))
    elif tag == "powerlaw":
        ds = synthetic_power_law(100_000, 1_000_000, num_feats=602,
                                 num_classes=16, seed=0)
        pad = ds.graph.to_padded_sampled(32, np.random.RandomState(99))
    else:
        raise ValueError(tag)
    return ds, pad


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_calls(fn, dev: torch.device, reps: int = TIMED_REPS):
    """fn() once warm, then ``reps`` calls, each between two
    synchronisations: (the median s of a call, [s of each call], the
    kernel launches of the first timed call, the last call's result)."""
    fn()
    ts = []
    for rep in range(reps):
        sync(dev)
        if rep == 0:
            agg.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
        if rep == 0:
            launches = dict(agg.LAUNCHES)
    return float(np.median(ts)), ts, launches, out


def card(dev: torch.device) -> tuple[str, str | None]:
    """(device name, power limit as nvidia-smi prints it); ("cpu", None)
    on the CPU."""
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return torch.cuda.get_device_name(dev), limit


def _setup(ds, pad, dtype, batch, steps, hidden, dev, agg_func="MEAN",
           feats=None):
    """The config, float32 master params from a torch.Generator seeded
    PARAM_SEED, the feature table in the compute dtype (``ds.features``
    uploaded, or ``feats`` as given: a table already on ``dev``), a
    HopSampler on a device generator seeded SAMPLER_SEED, and the batch
    stack RandomState(0).randint(0, N, (steps, batch)) with its labels."""
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=hidden, compute_dtype=dtype,
                           agg_func=agg_func)
    gen = torch.Generator().manual_seed(PARAM_SEED)
    params = _leaf_params({"sage": init_graphsage(gen, mcfg),
                           "clf": init_classifier(gen, hidden,
                                                  ds.num_classes)}, dev)
    if feats is None:
        feats = torch.from_numpy(ds.features).to(dev, compute_dtype(mcfg))
    hop = HopSampler(torch.from_numpy(pad.neighbors).to(dev),
                     torch.from_numpy(pad.degrees).to(dev),
                     torch.Generator(device=dev).manual_seed(SAMPLER_SEED))
    ids = np.random.RandomState(0).randint(0, ds.num_nodes,
                                           size=(steps, batch))
    batches = torch.from_numpy(ids.astype(np.int32)).to(dev)
    labels = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)
    return mcfg, params, feats, hop, batches, labels[batches.long()]


def cached_epoch(mcfg: GraphSageConfig, fanout: int = 10, pairs=None):
    """The program a cached row times: ``epoch(params, feats, hop, batches,
    labels) -> losses [T]``, a refresh and then T steps on its cache.  With
    ``pairs`` (one step's pair tensors) every step is the unsup "normal"
    step on those pairs."""
    step = cached.CachedStep(mcfg, fanout=fanout,
                             learn_method="sup" if pairs is None else "unsup")

    def epoch(params, feats, hop, batches, labels):
        cache = cached.refresh_leaf_cache(hop, feats, fanout,
                                          agg=mcfg.agg_func)
        stack = (None if pairs is None else
                 {f: v.expand(batches.shape[0], *v.shape)
                  for f, v in pairs.items()})
        return cached.cached_epoch_reuse(step, params, feats, *cache, hop,
                                         batches, labels, pair_stack=stack)

    return epoch


def unsup_pairs(batch: int, dev: torch.device, n_targets: int = 4096,
                n_pos: int = 6, n_neg: int = 20, rng=None) -> dict:
    """The unsup row's pair tensors, synthesized at production shapes:
    targets the first ``n_targets`` rows, P positives and M negatives each
    drawn from ``rng`` (by default a new RandomState(3)) over the batch's
    rows (positives first), all masks 1.  Index content does not change
    the step's cost."""
    if rng is None:
        rng = np.random.RandomState(3)
    pos_q = rng.randint(0, batch, (n_targets, n_pos)).astype(np.int32)
    neg_q = rng.randint(0, batch, (n_targets, n_neg)).astype(np.int32)
    return {
        "target_rows": torch.arange(n_targets, dtype=torch.int32,
                                    device=dev),
        "pos_q": torch.from_numpy(pos_q).to(dev),
        "pos_mask": torch.ones(n_targets, n_pos, device=dev),
        "neg_q": torch.from_numpy(neg_q).to(dev),
        "neg_mask": torch.ones(n_targets, n_neg, device=dev),
        "node_valid": torch.ones(n_targets, device=dev),
    }


def _timed(epoch, args, steps: int, dev: torch.device):
    """One warm epoch, then TIMED_REPS epochs, each between two
    synchronisations.  Returns (median s a step, [s a step of each rep],
    the kernel launches of the first timed epoch)."""
    _, ts, launches, losses = timed_calls(lambda: epoch(*args), dev)
    if not bool(torch.isfinite(losses).all()):
        raise FloatingPointError(f"non-finite epoch losses: "
                                 f"{losses.tolist()}")
    reps = [t / steps for t in ts]
    return float(np.median(reps)), reps, launches


def _row_from_dt(name, pipeline, dtype, batch, ds, pad, dt, reps, launches,
                 fanout, hidden, dev, agg_func="MEAN", note=None):
    device, power_limit = card(dev)
    peak = PEAK_TFLOPS.get(device)
    flops = matmul_flops_per_step(pipeline, ds.num_nodes, ds.feature_dim,
                                  batch, fanout, hidden, ds.num_classes,
                                  agg_func)
    edges = dense.edges_per_batch(batch, 2, fanout)
    # the reference has no LSTM aggregator: the hybrid row compares against
    # its MEAN baseline
    ref = REFERENCE_EDGES_PER_SEC.get(agg_func,
                                      REFERENCE_EDGES_PER_SEC["MEAN"])
    row = {
        "name": name, "pipeline": pipeline, "dtype": dtype, "agg": agg_func,
        "batch": batch, "nodes": ds.num_nodes,
        "edge_slots": int(pad.true_degrees.sum()),
        "step_ms": dt * 1e3,
        "edges_per_sec": edges / dt,
        "matmul_tflops_per_sec": flops / dt / 1e12,
        "mfu": flops / dt / 1e12 / peak if peak else None,
        "device": device,
        "vs_reference": edges / dt / ref,
    }
    if note:
        row["note"] = note
    row.update(rep_step_ms=[r * 1e3 for r in reps], power_limit=power_limit,
               peak_tflops=peak, launches=launches)
    return row


def run_row(name, ds, pad, pipeline, batch, dtype, fanout=10, hidden=128,
            steps=20, agg_func="MEAN", note=None, device=None):
    """A sup row: the cached or dense epoch, timed."""
    dev = _resolve_device(device)
    mcfg, params, feats, hop, batches, labels = _setup(
        ds, pad, dtype, batch, steps, hidden, dev, agg_func)
    epoch = (cached_epoch(mcfg, fanout) if pipeline == "cached"
             else dense.make_dense_sup_epoch(mcfg, fanout=fanout))
    dt, reps, launches = _timed(epoch, (params, feats, hop, batches, labels),
                                steps, dev)
    return _row_from_dt(name, pipeline, dtype, batch, ds, pad, dt, reps,
                        launches, fanout, hidden, dev, agg_func, note)


def run_unsup_row(name, ds, pad, batch, dtype, fanout=10, hidden=128,
                  steps=20, n_targets=4096, n_pos=6, n_neg=20, device=None,
                  feats=None):
    """The unsup (normal loss) cached row: encode, the pair scores and the
    Q-weighted loss each step (``feats``: as :func:`_setup` takes it)."""
    dev = _resolve_device(device)
    mcfg, params, feats, hop, batches, labels = _setup(
        ds, pad, dtype, batch, steps, hidden, dev, feats=feats)
    epoch = cached_epoch(mcfg, fanout,
                         unsup_pairs(batch, dev, n_targets, n_pos, n_neg))
    dt, reps, launches = _timed(epoch, (params, feats, hop, batches, labels),
                                steps, dev)
    note = (f"unsup normal loss each step: pair scores via "
            f"ops/sddmm.pair_loss_scores (the gathered cosines at this "
            f"shape, {n_targets} targets x {n_pos}+{n_neg} pairs over "
            f"U={batch}: dense_block_pays is false, so pair_scores does not "
            f"launch) + Q-weighted loss; vs_reference uses the MEAN sup "
            f"baseline")
    row = _row_from_dt(name, "cached", dtype, batch, ds, pad, dt, reps,
                       launches, fanout, hidden, dev, "MEAN", note)
    row["learn_method"] = "unsup"
    row["n_targets"] = n_targets
    return row


def run_spec(spec: dict, ds, pad, device=None) -> dict:
    """One registry row on a loaded dataset."""
    if spec["kind"] == "unsup":
        return run_unsup_row(spec["name"], ds, pad, spec["batch"],
                             spec["dtype"], device=device)
    return run_row(spec["name"], ds, pad, spec["pipeline"], spec["batch"],
                   spec["dtype"], steps=spec["steps"],
                   agg_func=spec.get("agg", "MEAN"), note=spec.get("note"),
                   device=device)


def run_named_row(name: str, device=None) -> dict:
    """One registry row in this process (the ``--row`` child mode)."""
    spec = next((s for s in _row_specs() if s["name"] == name), None)
    if spec is None:
        raise ValueError(f"unknown bench row: {name}")
    return run_spec(spec, *_load_dataset(spec["dataset"]), device=device)


_ROW_MARK = "ROW_JSON:"
# below this much of the suite's budget a row is not started
_MIN_ROW_BUDGET_S = 45.0


def _tail(text: str, lines: int = 6) -> str:
    return " | ".join((text or "").strip().splitlines()[-lines:])[:500]


def _run_child(name: str, dev: torch.device, timeout_s: float) -> dict:
    """One row in a child process, once: its row, or an error row with the
    child's last lines."""
    cmd = [sys.executable, "-u", "-m", "graphsage_torch.bench", "--row",
           name, "--device", str(dev)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, cwd=_ROOT)
    except subprocess.TimeoutExpired as e:
        out = e.stderr or e.stdout or ""
        if isinstance(out, bytes):
            out = out.decode("utf-8", "replace")
        return {"name": name, "error": f"no result within {timeout_s:g} s "
                                       f"(child killed): {_tail(out, 4)}"}
    payload = next((ln[len(_ROW_MARK):] for ln
                    in reversed(proc.stdout.splitlines())
                    if ln.startswith(_ROW_MARK)), None)
    if proc.returncode != 0 or payload is None:
        return {"name": name, "error": f"rc={proc.returncode}: "
                f"{_tail(proc.stderr or proc.stdout)}"}
    return json.loads(payload)


def _run_inproc(name: str, dev: torch.device) -> dict:
    try:
        return run_named_row(name, dev)
    except Exception as e:  # noqa: BLE001 — the suite records every row
        traceback.print_exc()
        return {"name": name, "error": f"{type(e).__name__}: {e}"}


def _flush(rows, out: str) -> str:
    path = os.path.join(out, "BENCH_DETAIL.partial.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return path


def _finalize(rows, out: str) -> str:
    """Promote the partial file to BENCH_DETAIL.json when every row of the
    registry was measured or skipped for its absent data; returns the path
    of the file that holds the run."""
    complete = (len(rows) == len(_row_specs())
                and all("edges_per_sec" in r or "missing" in r
                        for r in rows))
    partial = _flush(rows, out)
    if not complete:
        return partial
    path = os.path.join(out, "BENCH_DETAIL.json")
    os.replace(partial, path)
    return path


def run_suite(dev: torch.device, out: str = DEFAULT_OUT) -> int:
    """Every registry row, headline first; prints the summary line last.
    Returns 1 when a row errored, else 0."""
    budget_s = float(os.environ.get("GS_BENCH_SUITE_BUDGET_S", "1200"))
    default_timeout_s = float(os.environ.get("GS_BENCH_ROW_TIMEOUT_S", "240"))
    inproc = bool(os.environ.get("GS_BENCH_INPROC"))
    os.makedirs(out, exist_ok=True)
    t0 = time.monotonic()
    deadline = t0 + budget_s
    rows = []
    for spec in _row_specs():
        name = spec["name"]
        missing = missing_data(spec["dataset"])
        remaining = deadline - time.monotonic()
        if missing:
            row = {"name": name, "skipped": f"dataset file absent: {missing}",
                   "missing": missing}
        elif remaining < _MIN_ROW_BUDGET_S:
            row = {"name": name, "skipped": f"suite budget exhausted "
                   f"({budget_s:g} s; {remaining:.0f} s left)"}
        elif inproc:
            row = _run_inproc(name, dev)
        else:
            row = _run_child(name, dev, min(
                spec.get("row_timeout_s", default_timeout_s), remaining))
        rows.append(row)
        print("#", json.dumps(row), file=sys.stderr, flush=True)
        _flush(rows, out)
    artifact = _finalize(rows, out)

    device, power_limit = card(dev)
    done = [r for r in rows if "edges_per_sec" in r]
    head = next((r for r in done if r["name"] == HEADLINE_ROW),
                max(done, key=lambda r: r["edges_per_sec"], default=None))
    summary = {"metric": "edges_per_sec_per_chip", "unit": "edges/s"}
    if head is None:
        summary.update(value=0, vs_baseline=0,
                       error="no bench row completed")
    else:
        summary.update(value=head["edges_per_sec"],
                       vs_baseline=head["vs_reference"], row=head["name"])
    summary.update(
        rows_completed=len(done),
        rows_failed=len([r for r in rows if "error" in r]),
        rows_skipped=len([r for r in rows if "skipped" in r]),
        suite_wall_s=time.monotonic() - t0, detail_artifact=artifact,
        device=device, power_limit=power_limit)
    print(json.dumps(summary), flush=True)
    return 1 if summary["rows_failed"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row", default=None,
                    help="run this one row and print it after "
                         f"{_ROW_MARK}")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory of the BENCH_DETAIL files")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.row:
        print(_ROW_MARK + json.dumps(run_named_row(args.row, dev)),
              flush=True)
        return 0
    return run_suite(dev, args.out)


if __name__ == "__main__":
    sys.exit(main())
