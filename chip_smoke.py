"""Drive graphsage_torch's serving and training paths on one NVIDIA card and
hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build the kernels from graphsage_torch/csrc with nvcc, one process per
   source, all at once, and the native host engine (csrc/gs_native.cpp)
   with g++ beside them (build seconds and nvcc's register report printed);
   time one warp's chain of dependent bfloat16 adds (the latency that
   bounds a long row of the scatter, ADD_NS).
2. A small graph through the kernels against a float64 numpy oracle of the
   reference semantics (MEAN/MAX x gcn).
3. Serving at full width: the 100,000-node, 1,000,000-edge power-law graph
   with 602 features, a width-32 sampled adjacency, a 2-layer GraphSAGE with
   hidden 128, weights from a seeded torch.Generator; for MEAN float32, MEAN
   bfloat16, MAX bfloat16 and LSTM float32 (a cell a layer, layer 1's 602
   wide), and, after phase 7, the cached-LSTM hybrid that (d) trained and
   exported (served with lstm_hybrid, from its bundle):
   - launch counts set to 0, then the main path a user calls:
     InferenceSession.embeddings(), predict/log_probs on three node
     batches, score_pairs, and an export_bundle -> from_bundle round trip
     that must give identical embeddings and predictions; counts read and
     held equal to those the code's rule predicts (one gather_mean /
     gather_max a MEAN / MAX layer; one gather_rows a block of an LSTM
     layer, infer.card_block's blocks);
   - embed-all time (host clock around a synchronised call, warm; median,
     min and max of 20, of 5 for LSTM), and the device's busy time by
     kernel over one embed-all (torch.profiler);
   - the full embedding table against the same session run through the
     plain versions on the card;
   - each kernel alone at that layer's shapes against its plain version,
     timed three ways (graphsage_torch.microbench.times): ``ms``, CUDA
     events over many warm launches of the wrapper; ``device_ms``, the
     kernel's own device time a launch (torch.profiler); ``host_us``, the
     wrapper's host time a call; beside its byte bound, the plain version's
     time and a one-call library yardstick (its ms and device_ms); for LSTM
     gather_rows at one layer-1 block.

4. Training at full width (compact pipeline, the CLI's default), on the
   same graph: 2-layer MEAN GraphSAGE, hidden 128, fanout 10, b_sz 20, lr
   0.7, seed 824, float32.  Two cuts, both of scale only: the train split
   is cut to its first 1,000 nodes, so an epoch is 50 steps; negatives are
   "uniform" (GS_EXACT_NEG_BUDGET_S=0), because "auto" chooses by the
   host's core count.  The graph, the features and the widths are not cut.
   For plus_unsup (normal loss, 100 negatives) and sup MEAN, sup MAX gcn,
   and plus_unsup LSTM:
   - launch counts set to 0, then one epoch through Trainer.fit
     (train_epoch + evaluate); counts read and held equal to the
     prediction of compact_launches: the layer kernel (gather_mean,
     gather_max, or gather_rows for the LSTM's slot gather) 2 a step plus 2
     per embedding of val (and of test, when val F1 improved), pair_scores
     1 a step under plus_unsup, and for MAX one tie-gather gather_rows a
     step (layer 2's backward);
   - the same epoch through the plain versions on the card, from the same
     initial params and RandomState (so the same host batches), in
     lockstep: each plain step starts from the kernel run's params of that
     step, and its loss and updated params are held to the tolerances
     below (the last step's are the final params); for MEAN a
     free-running plain epoch is printed beside it, not asserted;
   - ms/step (host clock around each synchronised step; median of steps 6
     to 50, min, max), the loss curve, val F1, and the device's busy time
     by kernel and idle share over a 5-step epoch (torch.profiler).
5. The pair-score kernel at the step's own shape (20 targets over the
   step's padded rows, H=128), at [512 x 2048] H=128 and at a ragged
   [3 x 1000] H=100 case with zero rows: forward (float32 and bfloat16)
   and gradient through PairScores against the plain version, and a kernel
   row like the aggregate kernels' (yardstick: torch.mm of F.normalize'd
   rows); cached (c)'s step shape has its own row in phase 7.
   gather_mean at the step's two layer shapes: the forward kernel
   row and the scatter-add gradient against autograd through the plain
   version.  gather_max at the MAX step's two layer shapes (exact), and
   its tie-splitting backward (agg.max_aggregate_backward: the gather_rows
   tie gather, the tie test, the scatter) against autograd through the
   plain version, as a row of the whole composition; gather_rows at the LSTM
   step's layer-1 slot gather.
6. End to end through the entry points, on powerlaw:2000:10000: the CLI
   trains plus_unsup for one epoch on the card and exports a bundle
   (graphsage_torch.cli.run, what ``main`` runs); the bundle's params equal
   the trainer's best-val snapshot exactly; InferenceSession.from_bundle
   serves it, its table equal to infer.full_graph_embeddings of those
   params; val micro-F1 printed.  Then the CLI with ``--pipeline cached
   --table_cap 8`` trains plus_unsup for two epochs on the card, through
   gather_rows, gather_mean and pair_scores.
7. Cached training at full width (``--pipeline cached``, CachedTrainer) on
   the same graph and features, table_cap 32 (``RandomState(824)``), 2
   layers, hidden 128, fanout 10, lr 0.7, seed 824, float32, four
   configurations:
   (a) sup MEAN, plain batches of 32768 over the whole train split (2 steps
       an epoch, the tail wrap-padded and masked), 3 epochs with
       refresh_every 2: the full-table layer-1 branch;
   (b) sup MAX gcn, plain batches of 512, the train split cut to its first
       5,120 nodes (10 steps): the per-occurrence branch, gather_max in the
       refresh;
   (c) plus_unsup MEAN, extended batches of 20, the train split cut to
       1,000 nodes (50 steps), uniform negatives: the full-table branch and
       the pair_scores block;
   (d) sup LSTM, the cached-LSTM hybrid (MEAN leaf cache, the live layer-2
       cell over the tree-contiguous [32768, 11, 128] sequence), plain
       batches of 32768 over the whole train split, 2 epochs: the JAX
       bench's powerlaw100k_b32768_cached_bfloat16_lstm_hybrid row in
       float32.  Its layer-0 cell must come out of the fit unchanged; the
       trained model is exported for phase 3.
   For each: launch counts set to 0, then CachedTrainer.fit, every step,
   refresh and sampler draw recorded; counts read and held equal to the
   counts predicted from the code; the first refresh against its plain
   version on the same samples (MAX exact); every step again through the
   plain versions in lockstep (from the kernel run's params, cache and
   draws of that step); refresh_ms (median of 5, min, max); ms_per_step
   (median of 20 steps on one cache, min, max); the device time by kernel
   and the idle share over one epoch (torch.profiler); val F1.  Then
   gather_mean / gather_max kernel rows at the refresh shape (idx [100000,
   10] over [100000, 602]), gather_rows rows at (a)'s full-table and (b)'s
   per-occurrence gathers, equal to index_select bit for bit, and a
   pair_scores row at (c)'s own step shape (the score block one recorded
   step hands the kernel: B from its target_rows, U from its batch, with
   (c)'s launch count), with phase 5's checks.
8. The port's microbench (graphsage_torch.microbench) at
   tools/pallas_microbench.py's shapes: row gather, gather+mean,
   scatter-add (unsorted and presorted) and the [512 x 2048] score block,
   and at the cached pipeline's 602-wide shapes (a row gather of 5,632 ids,
   gather+mean at the refresh's [100000, 10]); its row gather (45,056 x 11
   ids over [100000, 128], equal to index_select bit for bit) is
   gather_rows' kernel row at that shape.
9. bfloat16 training at full width (float32 master params, the feature
   table and the leaf cache in bfloat16; the table_cap-32 adjacency of
   phase 7; weights from a torch.Generator seeded 824, the sampler's seeded
   825), on the JAX bench's bfloat16 rows:
   (e) cached sup MEAN, batches of 65536 (the headline row,
       powerlaw100k_b65536_cached_bfloat16): one refresh, then 20 steps of
       RandomState(0).randint(0, N, (20, 65536)) through
       cached.cached_epoch_reuse (the full-table branch);
   (h) cached sup MAX, batches of 32768, 10 steps; (i) the cached-LSTM
       hybrid, batches of 32768, 5 steps (fewer than (e), for time);
   (f) the dense pipeline, sup MEAN, batches of 4096: 20 steps of
       train.dense.make_dense_sup_epoch;
   (g) compact plus_unsup MEAN through Trainer, 50 steps over the
       1,000-node split, as phase 4 runs it in float32; (j) compact sup
       MAX gcn the same way (its layer-2 tie backward in bfloat16).
   For each: launch counts set to 0, the main path, counts read and held
   equal to those predicted from the code (in bfloat16 every gradient of
   a row gather is one scatter_rows launch: bf16_scatters, and one a step
   on the cached full-table branch); the refresh and every step
   again through the plain versions on the recorded draws, in lockstep
   from the kernel run's params (bfloat16 tolerances below);
   refresh_ms, ms_per_step (median, min, max), edges_per_batch over the
   step time as edges/s, the epoch's idle share (torch.profiler).  For (e)
   and (f) the device time of the float32 upcast of the bfloat16 table and
   of the float32 GEMM on it; for (e) the layer-1 gather's bfloat16
   scatter backward (720,896 rows into [100000, 128]) against a float64
   sum: the port's (scatter_rows, JAX's order), index_add_'s bfloat16
   atomics and float32.  Kernel rows in bfloat16: gather_mean / gather_max
   at the refresh shape, gather_rows and scatter_rows at the three
   full-table gathers and their backward, gather_mean at the dense and
   compact layers with their gradient and a scatter_rows row at its
   shape, pair_scores at (g)'s step, gather_max and its backward
   composition at (j)'s layers.
10. Checkpoints, --config, --resume and the wedge-and-relaunch loop at full
   width (files under build/chip_smoke_resume), through the entry points a
   user runs:
   (k) the headline bf16 cached configuration through the CLI
       (powerlaw:100000:1000000, a HOCON --config giving 2 layers and
       hidden 128, --pipeline cached --table_cap 32 --no_extend --b_sz
       32768 --compute_dtype bfloat16, sup, 3 epochs, --export): once
       unbroken in this process (launch counts read: gather_rows,
       gather_mean and scatter_rows each > 0; checkpoint writes timed),
       then under ``python -m graphsage_torch.supervise`` with a wedge
       injected at epoch 1 (GS_TEST_WEDGE_SENTINEL): launch, exit 17,
       restart with --resume of model_best_k_ep0_*, launch, exit 0.  Epochs
       1-2's mean_loss and val_f1 and the exported params must equal the
       unbroken run's bit for bit (every gradient scatter on the path is
       scatter_rows, deterministic); so must the final params and the last
       epoch's step losses of the CLI resumed in this process from the
       checkpoint the supervisor resumed from.  Printed: the time to
       recover, from the child's exit 17 to the end of the relaunched
       child's first epoch, and its parts; the checkpoint writes' ms and
       bytes.
   (l) float32 compact sup on powerlaw:2000:10000, the same ways, held to
       the float32 lockstep bars (float32 gathers' backward is index_add_,
       whose atomics add in varying order): epochs 1-2's mean losses, the
       last epoch's step losses and the final params.
   (m) in a subprocess, a fetch_with_deadline behind 5 s of queued device
       time (torch.cuda._sleep) must raise FetchDeadlineError after its 1 s
       deadline (within 3 s), and the CLI's exit path must end the process
       with code 17 within 10 s.  Then a real step: the CLI trains compact
       sup at full width (powerlaw:100000:1000000, 2 layers, hidden 128)
       with 30 s of device sleep queued inside its 20th step, between the
       encode and the update, and a 2 s deadline; the process must end
       with code 17, the step's loss fetch named, within 3 deadlines of
       the sleep.

Tolerances: float32 rtol=atol=1e-5; bfloat16 within 2 bf16 ulps of the
reference value (the two versions may sum in different orders); MAX and the
row gather exact;
bfloat16 pair scores within 2 ulps plus 1e-5 (SCORES_BF16_ATOL).
Gradients: float32 rtol=atol=1e-5 (float32 scatters are index_add_,
atomics in no fixed order); bfloat16 scatter-adds keep JAX's order
(ops/scatter.py), so a bfloat16 gradient on the card equals the same one
on the CPU bit for bit.  Training, kernels against plain versions in lockstep:
float32 step losses rtol LOSS_RTOL, params after each step atol PARAM_ATOL;
bfloat16 losses rtol BF16_LOSS_RTOL, each step's update within
BF16_UPDATE_RTOL of its largest element (see those constants).

The last lines are a JSON object of per-kernel results, the card's name and
power limit from nvidia-smi, and the result line
{"ok": true, "device": {...}}.  Matrix products run in full float32
(TF32 off).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from graphsage_torch import cli, infer, microbench
from graphsage_torch.convert import flatten_params, params_to_numpy
from graphsage_torch.data import (CSRGraph, PaddedAdjacency,
                                  synthetic_power_law)
from graphsage_torch.microbench import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                        cuda_ms, device_ms, times)
from graphsage_torch.models import (GraphSageConfig, graphsage,
                                    init_classifier, init_graphsage, lstm_agg)
from graphsage_torch.native import build as native_build
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import build, gather, scatter, sddmm
from graphsage_torch.sampler.compact import _bucket
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import (CachedTrainer, Trainer, TrainConfig,
                                   cached, dense, micro_f1)
from graphsage_torch.train.optim import tree_leaves
from graphsage_torch.train.trainer import _leaf_params

NODES, EDGES, FEATS, CLASSES, WIDTH, HIDDEN = (100_000, 1_000_000, 602, 16,
                                               32, 128)
CONFIGS = (("MEAN", "float32"), ("MEAN", "bfloat16"), ("MAX", "bfloat16"),
           ("LSTM", "float32"))
SOURCE = "graphsage_torch/csrc/aggregate.cu"
SCORE_SOURCE = "graphsage_torch/csrc/sddmm.cu"
GATHER_SOURCE = "graphsage_torch/csrc/gather.cu"
SCATTER_SOURCE = "graphsage_torch/csrc/scatter.cu"
# scatter_rows: the XLA scatter of the Pallas aggregates' VJP
# (_pallas_mean_bwd), which jnp.take's VJP shares
REPLACES = {"gather_mean": "graphsage_tpu/ops/pallas_aggregate.py:60",
            "gather_max": "graphsage_tpu/ops/pallas_aggregate.py:76",
            "pair_scores": "graphsage_tpu/ops/sddmm.py:156",
            "gather_rows": "tools/pallas_microbench.py:87",
            "scatter_rows": "graphsage_tpu/ops/pallas_aggregate.py:147"}
TRAIN_NODES, B_SZ, LR, FANOUT, SEED = 1000, 20, 0.7, 10, 824
# kernels against plain versions, step by step from the same params (see
# train_method): the pair-score kernel sums in another order than
# torch.matmul and index_add_ adds with atomics, so a step's loss and
# update differ in the last bits (PERF.md, training section)
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
# bfloat16 scores: both versions sum in float32 (in other orders, up to
# ~1e-5 apart at H=128) and round once; near 0, where the sum cancels,
# that difference is many bf16 ulps, so 2 ulps plus this absolute term
SCORES_BF16_ATOL = 1e-5
# bfloat16 training, kernels against plain versions in lockstep: the plain
# versions' autograd scatters bfloat16 contributions in other orders than
# JAX's (index_add_'s atomics, or a sort and float32 sums), so a step's
# update differs by bfloat16 roundings; the bars the CPU tests hold the
# port's bfloat16 step to against the JAX package's
BF16_LOSS_RTOL, BF16_UPDATE_RTOL = 1e-2, 2e-2
# ns of one dependent bfloat16 add on the card (add_latency, phase 1): the
# chain bound of a scatter_rows row
ADD_NS = 0.0
# the git-ignored directory the script's bundles and checkpoints go to
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                exact: bool = False, bf16_atol: float = 0.0) -> float:
    """Max abs error of got vs want; raises outside the stated tolerance.
    bf16_atol widens the bf16 tolerance where both sides round a float32
    result of cancelling sums (dot products near 0)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        ok = bool(torch.equal(got, want))
    elif want.dtype == torch.bfloat16:
        ok = bool((diff <= 2 * bf16_ulp(want) + bf16_atol).all())
    else:
        ok = bool((diff <= 1e-5 + 1e-5 * want.float().abs()).all())
    if not ok:
        raise AssertionError(f"{name}: max abs error {err} outside "
                             f"tolerance")
    return err


@contextlib.contextmanager
def patched(module, **attrs):
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def plain_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_rows' plain version: indexing, differentiated by autograd."""
    return table[idx.long()]


@contextlib.contextmanager
def plain_aggregates():
    """Serving through the plain versions on the card (the reference run):
    the LSTM's slot gather through index_select."""
    with patched(infer, mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain), \
            patched(lstm_agg, gather_rows=gather.gather_rows_plain):
        yield


# ------------------------------------------------------------ small oracle

def numpy_oracle(params, cfg, feats, g: CSRGraph) -> np.ndarray:
    """Layer-wise propagation over full neighbour sets in float64 (the
    reference's aggregation semantics, src/models.py:291-330)."""
    h = feats.astype(np.float64)
    for layer in range(cfg.num_layers):
        w = params["layers"][layer]["weight"].double().numpy()
        out = np.zeros((g.num_nodes, w.shape[0]))
        for v in range(g.num_nodes):
            neigh = [u for u in g.neighbors(v) if u != v]
            members = ([v] + neigh) if cfg.gcn else neigh
            agg_v = np.zeros(h.shape[1])
            if members:
                rows = h[np.asarray(members)]
                agg_v = rows.mean(0) if cfg.agg_func == "MEAN" else rows.max(0)
            combined = agg_v if cfg.gcn else np.concatenate([h[v], agg_v])
            out[v] = np.maximum(combined @ w.T, 0.0)
        h = out
    return h


def small_graph_check(dev: torch.device) -> None:
    rng = np.random.RandomState(3)
    n = 37
    src = np.concatenate([np.arange(n), rng.randint(0, n, 90), [5]])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.randint(0, n, 90), [5]])
    g = CSRGraph.from_edges(n, src, dst)
    feats = rng.randn(n, 12).astype(np.float32)
    for agg_func in ("MEAN", "MAX"):
        for gcn in (False, True):
            cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8,
                                  agg_func=agg_func, gcn=gcn)
            params = init_graphsage(torch.Generator().manual_seed(0), cfg)
            got = infer.full_graph_embeddings(params, cfg, feats,
                                              g.to_padded(), device=dev)
            want = numpy_oracle(params, cfg, feats, g)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    log("small graph: MEAN/MAX x gcn on the card match the float64 oracle "
        "(rtol 2e-4, atol 2e-5)")


# ------------------------------------------------------------ kernel rows

def kernel_row(name: str, label: str, embed: torch.Tensor,
               idx: torch.Tensor, mask: torch.Tensor,
               launches: int) -> dict:
    kernel = agg.mean_aggregate if name == "gather_mean" else agg.max_aggregate
    plain = (agg.mean_aggregate_plain if name == "gather_mean"
             else agg.max_aggregate_plain)
    got = kernel(embed, idx, mask)
    torch.cuda.synchronize()
    err = check_close(f"{name} {label}", got, plain(embed, idx, mask),
                      exact=name == "gather_max")

    valid = mask > 0
    u, s = idx.shape
    d = embed.shape[1]
    rows_read = int(torch.unique(idx[valid]).numel())
    n_valid = int(valid.sum())
    nbytes = (rows_read * d * embed.element_size() + idx.numel() * 4
              + mask.numel() * 4 + u * d * embed.element_size())
    ops = n_valid * d * (2 if name == "gather_mean" else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S

    if name == "gather_mean":
        weights = (mask / mask.sum(1, keepdim=True).clamp_min(1.0)).to(
            embed.dtype)
        library = lambda: F.embedding_bag(idx, embed, mode="sum",
                                          per_sample_weights=weights)
        library_note = "F.embedding_bag(mode='sum', per_sample_weights)"
    else:
        flat = idx[valid]
        offsets = torch.zeros(u, dtype=idx.dtype, device=idx.device)
        offsets[1:] = valid.sum(1).cumsum(0)[:-1].to(idx.dtype)
        library = lambda: F.embedding_bag(flat, embed, offsets, mode="max")
        library_note = "F.embedding_bag(mode='max') over the valid slots"
    library_err = float((library().float() - got.float()).abs().max())

    row = {
        "name": f"{name} ({label})",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: kernel(embed, idx, mask), "gather_reduce_kernel",
                library=library, reps=20),
        "plain_ms": cuda_ms(lambda: plain(embed, idx, mask), reps=5),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"kernel {row['name']}: embed {tuple(embed.shape)} stride "
        f"{embed.stride(0)} {embed.dtype}, idx {tuple(idx.shape)}, "
        f"{n_valid} valid slots, {rows_read} rows read, {nbytes} bytes; "
        f"{timing_note(row)} [{library_note}, max abs diff to the kernel "
        f"{library_err}] max_abs_err {err}")
    return row


def timing_note(row: dict) -> str:
    library = ("library_ms none" if row["library_ms"] is None else
               f"library_ms {row['library_ms']:.6f} library_device_ms "
               f"{row['library_device_ms']:.6f}")
    return (f"ms {row['ms']:.6f} device_ms {row['device_ms']:.6f} host_us "
            f"{row['host_us']:.3f} bound_ms {row['bound_ms']:.6f} "
            f"({row['bound_ms'] / row['device_ms']:.0%} of it) plain_ms "
            f"{row['plain_ms']:.6f} {library}")


# ------------------------------------------------------------ serving

def profile_device(fn, wall_ms: float, what: str = "embed_all_ms",
                      top: int = 8) -> None:
    """Device kernel time by kernel over one call of fn (torch.profiler),
    and the device's idle share against the warm wall time of that call.
    The port's own kernels are listed even when they are not in the top."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(evt.self_device_time_total, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total]
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return
    busy = sum(t for t, _, _ in rows) / 1e3
    log(f"  profile: device busy {busy:.6f} ms of {what} "
        f"{wall_ms:.6f} (idle share {1 - busy / wall_ms:.4f}); by kernel:")
    ours = ("gather_reduce_kernel", "pair_scores_kernel",
            "gather_rows_kernel", "count_kernel", "place_kernel",
            "sum_kernel")
    for rank, (t, key, count) in enumerate(sorted(rows, reverse=True)):
        if rank < top or any(name in key for name in ours):
            log(f"    {t / 1e3:10.6f} ms  x{count:<3d} {key[:100]}")


def serving_launches(cfg: GraphSageConfig, lstm_hybrid: bool) -> dict:
    """The launches of one embeddings() call, from the code's rule: one
    gather_mean / gather_max a MEAN / MAX layer, and a gather_rows a block
    of an LSTM layer (infer.card_block at the layer's input width)."""
    want = {"gather_mean": 0, "gather_max": 0, "pair_scores": 0,
            "gather_rows": 0, "scatter_rows": 0}
    itemsize = graphsage.compute_dtype(cfg).itemsize
    for layer in range(cfg.num_layers):
        agg_func = "MEAN" if lstm_hybrid and layer == 0 else cfg.agg_func
        if agg_func == "LSTM":
            block = infer.card_block("LSTM", NODES, WIDTH + cfg.gcn,
                                     cfg.layer_input_size(layer), itemsize)
            want["gather_rows"] += -(-NODES // block)
        else:
            want["gather_mean" if agg_func == "MEAN" else "gather_max"] += 1
    return want


def serve_config(tag: str, cfg: GraphSageConfig, params: dict,
                 feats: torch.Tensor, pad, n_valid: int, dev: torch.device,
                 lstm_hybrid: bool = False) -> tuple[dict, list]:
    """Phase 3 for one model: the counted main path, embed_all_ms, the
    device profile, the table against the plain versions, and the kernel
    rows at its layers' shapes."""
    dtype = cfg.compute_dtype
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, NODES, size) for size in (1, 64, 4096)]

    # -------- the main path, counted
    agg.reset_launches()
    t0 = time.perf_counter()
    sess = infer.InferenceSession(params, cfg, feats, pad,
                                  lstm_hybrid=lstm_hybrid, device=dev)
    emb = sess.embeddings()
    preds = []
    for nodes in batches:
        lp = sess.log_probs(nodes)
        preds.append(sess.predict(nodes))
        assert lp.shape == (len(nodes), CLASSES) and np.isfinite(lp).all()
        np.testing.assert_allclose(np.exp(lp).sum(1), 1.0, rtol=1e-4)
        np.testing.assert_array_equal(preds[-1], lp.argmax(1))
    scores = sess.score_pairs(batches[2][:100], batches[2][100:200])
    assert scores.shape == (100,) and (np.abs(scores) <= 1 + 1e-5).all()
    bundle = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_bundles", tag.replace(" ", "_"))
    infer.export_bundle(bundle, params, cfg, CLASSES,
                        meta={"lstm_hybrid": True} if lstm_hybrid else None)
    again = infer.InferenceSession.from_bundle(bundle, feats, pad,
                                               device=dev)
    assert again.lstm_hybrid == lstm_hybrid
    np.testing.assert_array_equal(again.embeddings(), emb)
    for nodes, want in zip(batches, preds):
        np.testing.assert_array_equal(again.predict(nodes), want)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    # two embeddings() calls, two sessions
    want = {k: 2 * v for k, v in serving_launches(cfg, lstm_hybrid).items()}
    log(f"[{tag}] main path: 2 sessions, 3 batches, score_pairs, bundle "
        f"round trip in {serve_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}")
    assert emb.shape == (NODES, HIDDEN) and np.isfinite(emb).all()
    assert np.abs(emb).sum() > 0
    assert launches == want, (launches, want)

    # -------- embed-all time (warm, device-resident inputs)
    def embed_all():
        return infer.full_graph_embeddings(sess.params["sage"], cfg,
                                           sess.feats, sess.pad, fetch=False,
                                           lstm_hybrid=lstm_hybrid,
                                           device=dev)

    embed_all()
    times = []
    for _ in range(5 if cfg.agg_func == "LSTM" else 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embed_all()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    log(f"[{tag}] embed_all_ms {ms:.6f} (median of {len(times)}; min "
        f"{min(times) * 1e3:.6f}, max {max(times) * 1e3:.6f}) nodes_per_s "
        f"{NODES / ms * 1e3:.1f} edge_slots_per_s "
        f"{2 * n_valid / ms * 1e3:.1f}")
    profile_device(embed_all, ms)

    # -------- whole table against the plain versions on the card
    table = embed_all()
    with plain_aggregates():
        ref = embed_all()
    err = check_close(f"[{tag}] embedding table vs plain", table, ref)
    log(f"[{tag}] embedding table vs plain versions on the card: max abs "
        f"error {err}")

    # -------- each kernel alone at its layer's shapes
    summary = {"config": tag, "embed_all_ms": ms}
    if lstm_hybrid:
        return summary, []    # its kernels have rows at MEAN's and LSTM's
    idx, mask = infer._slot_table(sess.pad.neighbors, sess.pad.degrees,
                                  cfg.gcn)
    h0 = sess.feats.to(getattr(torch, dtype))
    rows = []
    with torch.no_grad():
        if cfg.agg_func == "MEAN":
            from graphsage_torch.models.layers import mean_pretransform
            z = mean_pretransform(sess.params["sage"]["layers"][0]["weight"],
                                  h0)
            rows.append(kernel_row("gather_mean", f"{dtype}, both layers",
                                   z[:, HIDDEN:], idx, mask,
                                   launches["gather_mean"]))
        elif cfg.agg_func == "MAX":
            h1 = infer._layer_full(cfg, sess.params["sage"], 0, h0, idx,
                                   mask, NODES, "MAX")
            for layer, h in ((1, h0), (2, h1)):
                rows.append(kernel_row("gather_max", f"{dtype}, layer "
                                       f"{layer}", h, idx, mask,
                                       launches["gather_max"]))
        else:
            block = infer.card_block("LSTM", NODES, idx.shape[1], FEATS,
                                     h0.element_size())
            rows.append(gather_row(
                f"serving LSTM layer-1 block, {block} x {idx.shape[1]} ids "
                f"over [{NODES}, {FEATS}]", h0, idx[:block].reshape(-1),
                launches["gather_rows"]))
    return summary, rows


# ------------------------------------------------------------ training

@contextlib.contextmanager
def plain_training():
    """Training through the plain versions on the card (the reference
    run): autograd differentiates them (max_aggregate_plain's amax splits
    ties equally; the LSTM's slot gather is index_select)."""
    with patched(graphsage, mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain,
                 take_rows=plain_take), \
            patched(scatter, take_rows=plain_take), \
            patched(lstm_agg, gather_rows=gather.gather_rows_plain), \
            patched(sddmm, pair_scores=sddmm.dense_pair_scores):
        yield


def make_trainer(ds, method: str, dev: torch.device, agg_func: str = "MEAN",
                 gcn: bool = False, dtype: str = "float32") -> Trainer:
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=agg_func, gcn=gcn, compute_dtype=dtype)
    tcfg = TrainConfig(learn_method=method, unsup_loss="normal", epochs=1,
                       b_sz=B_SZ, lr=LR, fanout=FANOUT, seed=SEED,
                       verbose=False)
    return Trainer(ds, cfg, tcfg, device=dev)


def bf16_scatters(cfg: GraphSageConfig, n: int, u0: int,
                  frontier_rows: list[int]) -> int:
    """scatter_rows launches of one bfloat16 training step through
    graphsage_apply_gathered (the compact and dense pipelines; float32
    scatters are index_add_): a layer whose input carries a gradient
    scatters its aggregate's backward once and, unless gcn, its self-row
    gather's once.  Layer 1 reads the constant feature table [n, FEATS]
    through u0 gathered rows; its input carries a gradient only where it is
    transformed first (the whole table, or the MEAN pretransform of the
    gathered rows, by the models' own rules); every later layer's does."""
    if cfg.compute_dtype != "bfloat16":
        return 0
    per_layer = 1 if cfg.gcn else 2
    table = (cfg.agg_func == "MEAN" and cfg.mean_pretransform != "never"
             and cfg.impl != "pallas"
             and (cfg.mean_pretransform == "always" or n <= 2 * u0))
    first = table or graphsage._use_pretransform(
        cfg, torch.empty(u0, FEATS, device="meta"),
        graphsage.Frontier(idx=torch.empty(frontier_rows[0], 1,
                                           device="meta"),
                           mask=None, self_idx=None))
    return per_layer * (int(first) + cfg.num_layers - 1)


def compact_launches(cfg: GraphSageConfig, method: str, step_args: list,
                     evals: int) -> dict:
    """What the compact Trainer launches in a fit: per encode (each step,
    and each evaluation embedding) one aggregate kernel a layer
    (gather_mean, gather_max, or gather_rows for the LSTM's slot gather);
    per step under an unsupervised loss one pair_scores where
    sddmm.dense_block_pays picks the score block for the step's pair batch;
    and for MAX one tie-gather gather_rows a differentiated layer a step
    (every layer above the first: the first aggregates constant feature
    rows); in bfloat16, the backward's scatter_rows by bf16_scatters."""
    steps = len(step_args)
    want = {"gather_mean": 0, "gather_max": 0, "pair_scores": 0,
            "gather_rows": 0, "scatter_rows": 0}
    kernel = {"MEAN": "gather_mean", "MAX": "gather_max",
              "LSTM": "gather_rows"}[cfg.agg_func]
    want[kernel] += cfg.num_layers * (steps + evals)
    if cfg.agg_func == "MAX":
        want["gather_rows"] += (cfg.num_layers - 1) * steps
    for pb, cb, _, _ in step_args:
        want["scatter_rows"] += bf16_scatters(
            cfg, NODES, len(cb.x0_ids), [f.idx.shape[0] for f in cb.frontiers])
        if method != "sup":
            want["pair_scores"] += sddmm.dense_block_pays(
                pb.target_rows.shape[0], cb.out_rows,
                pb.pos_q.size + pb.neg_q.size, cfg.out_size)
    return want


def fit_timed(tr: Trainer, before=None, after=None,
              step_args: list | None = None) -> tuple[list[float], float]:
    """Trainer.fit for one epoch, with each step synchronised and timed on
    the host clock; before(i) / after(i) run around step i, outside the
    timed window, and each step's host batch is appended to ``step_args``
    when given.  Returns (step ms, fit seconds)."""
    step_ms = []
    step = tr._step

    def timed_step(*args):
        i = len(step_ms)
        if step_args is not None:
            step_args.append(args)
        if before is not None:
            before(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(i)
        return loss

    tr._step = timed_step
    try:
        t0 = time.perf_counter()
        tr.fit()
        fit_s = time.perf_counter() - t0
    finally:
        tr._step = step
    return step_ms, fit_s


def snapshot(params) -> list[torch.Tensor]:
    return [p.detach().clone() for p in tree_leaves(params)]


def param_snapshot(tr: Trainer) -> list[torch.Tensor]:
    return snapshot(tr.params)


def max_abs_diff(a: list[torch.Tensor], b: list[torch.Tensor]) -> float:
    return max(float((x.detach() - y).abs().max()) for x, y in zip(a, b))


def update_error(got: list, want: list, before: list) -> float:
    """How far the update ``got - before`` lies from ``want - before``,
    relative to the largest element of the latter, the worst leaf."""
    worst = 0.0
    for g, w, b in zip(got, want, before):
        scale = float((w - b).abs().max())
        err = float((g.detach() - w).abs().max())
        worst = max(worst, err / scale if scale else
                    (0.0 if err == 0 else float("inf")))
    return worst


def assert_lockstep(tag: str, dtype: str, loss_rel: list, abs_errs: list,
                    upd_errs: list) -> None:
    """float32: step losses within LOSS_RTOL and params after each step
    within PARAM_ATOL; bfloat16: losses within BF16_LOSS_RTOL and each
    step's update within BF16_UPDATE_RTOL of its largest element."""
    bf16 = dtype == "bfloat16"
    log(f"{tag} lockstep, kernels vs plain versions over {len(loss_rel)} "
        f"steps: step loss max relative difference {max(loss_rel):.3e} "
        f"(step {int(np.argmax(loss_rel)) + 1}; tolerance "
        f"{BF16_LOSS_RTOL if bf16 else LOSS_RTOL}); params after each step "
        f"max abs difference {max(abs_errs):.3e}"
        f"{'' if bf16 else f' (tolerance {PARAM_ATOL})'}; update max "
        f"difference {max(upd_errs):.3e} of its largest element"
        f"{f' (tolerance {BF16_UPDATE_RTOL})' if bf16 else ''}")
    if bf16:
        assert max(loss_rel) <= BF16_LOSS_RTOL, loss_rel
        assert max(upd_errs) <= BF16_UPDATE_RTOL, upd_errs
    else:
        assert max(loss_rel) <= LOSS_RTOL, loss_rel
        assert max(abs_errs) <= PARAM_ATOL, abs_errs


def capture_step_inputs(tr: Trainer) -> dict:
    """The tensors each kernel of one training step is called with: one
    more batch built and stepped (after the counted run) with recorders in
    front of the kernels' wrappers."""
    seen = {"gather_mean": [], "gather_max": [], "pair_scores": [],
            "gather_rows": []}

    def mean_rec(embed, idx, mask):
        seen["gather_mean"].append((embed.detach(), idx, mask))
        return agg.mean_aggregate(embed, idx, mask)

    def max_rec(embed, idx, mask):
        seen["gather_max"].append((embed.detach(), idx, mask))
        return agg.max_aggregate(embed, idx, mask)

    def rows_rec(table, idx):
        seen["gather_rows"].append((table.detach(), idx))
        return gather.gather_rows(table, idx)

    def scores_rec(emb, target_rows, eps=1e-8):
        seen["pair_scores"].append((emb.detach(), target_rows))
        return sddmm.PairScores.apply(emb, target_rows, eps)

    nodes = tr.ds.train_nodes[:B_SZ]
    with patched(graphsage, mean_aggregate=mean_rec, max_aggregate=max_rec), \
            patched(lstm_agg, gather_rows=rows_rec), \
            patched(sddmm, pair_scores=scores_rec):
        tr._step(*tr._build_train_batch(nodes))
    torch.cuda.synchronize()
    return seen


def train_method(method: str, ds, dev: torch.device, agg_func: str = "MEAN",
                 gcn: bool = False, free_running: bool = True,
                 dtype: str = "float32") -> dict:
    """One epoch of `method` through the kernels (counted), held step by
    step against the plain versions; returns what the kernel rows need.

    The plain run is in lockstep: before each of its steps it takes the
    kernel run's params from before that step, so each step's loss and
    update are compared from the same params and the same host batch.
    A free-running plain epoch (MEAN only) is printed beside it, not
    asserted: under plus_unsup, SGD at lr 0.7 can carry a last-bit
    difference (index_add_'s atomics, another order of the score sums) to
    an O(1) one within 50 steps."""
    tag = (f"[train {method}{'' if agg_func == 'MEAN' else ' ' + agg_func}"
           f"{' gcn' if gcn else ''}{' bf16' if dtype == 'bfloat16' else ''}"
           f"]")
    tr = make_trainer(ds, method, dev, agg_func, gcn, dtype)
    snaps, step_args = [], []
    agg.reset_launches()
    step_ms, fit_s = fit_timed(tr, before=lambda i: snaps.append(
        param_snapshot(tr)), step_args=step_args)
    launches = dict(agg.LAUNCHES)
    snaps.append(param_snapshot(tr))
    steps = len(step_ms)
    assert steps == TRAIN_NODES // B_SZ, steps
    val_f1 = tr.history[-1]["val_f1"]
    evals = 1 + ("test_f1" in tr.history[-1])
    want = compact_launches(tr.mcfg, method, step_args, evals)
    log(f"{tag} main path: Trainer.fit, {steps} steps + {evals} evaluation "
        f"embeddings in {fit_s:.3f} s; launches {launches}; predicted from "
        f"the code {want}")
    assert launches == want, (launches, want)

    ref = make_trainer(ds, method, dev, agg_func, gcn, dtype)
    step_errs, upd_errs = [], []

    def load(i):
        with torch.no_grad():
            for p, q in zip(tree_leaves(ref.params), snaps[i]):
                p.copy_(q)

    agg.reset_launches()
    def compare(i):
        got = tree_leaves(ref.params)
        step_errs.append(max_abs_diff(got, snaps[i + 1]))
        upd_errs.append(update_error(got, snaps[i + 1], snaps[i]))

    with plain_training():
        plain_ms, plain_s = fit_timed(ref, before=load, after=compare)
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    losses = np.asarray(tr.step_losses)
    ref_losses = np.asarray(ref.step_losses)
    assert np.isfinite(losses).all() and losses.shape == (steps,)
    rel = np.abs(losses - ref_losses) / np.abs(ref_losses)
    assert_lockstep(tag, dtype, list(rel), step_errs, upd_errs)
    del ref

    if free_running:
        free = make_trainer(ds, method, dev, agg_func, gcn)
        with plain_training():
            fit_timed(free)
        free_rel = (np.abs(losses - np.asarray(free.step_losses))
                    / np.abs(np.asarray(free.step_losses)))
        first = np.flatnonzero(free_rel > LOSS_RTOL)
        log(f"{tag} free-running plain epoch (not asserted): step loss "
            f"max relative difference {free_rel.max():.3e} (first above "
            f"{LOSS_RTOL}: step "
            f"{int(first[0]) + 1 if first.size else 'none'}); final params "
            f"max abs difference "
            f"{max_abs_diff(tree_leaves(free.params), snaps[-1]):.3e}; val "
            f"F1 {free.history[-1]['val_f1']:.6f}")
        del free

    tail = step_ms[5:]
    ref_tail = plain_ms[5:]
    log(f"{tag} ms_per_step {statistics.median(tail):.6f} (median of steps "
        f"6-{steps}; min {min(tail):.6f}, max {max(tail):.6f}); first step "
        f"{step_ms[0]:.6f}; plain versions "
        f"{statistics.median(ref_tail):.6f}; epoch + evaluation "
        f"{fit_s:.3f} s (plain versions {plain_s:.3f} s)")
    log(f"{tag} loss curve: " + " ".join(f"{x:.6f}" for x in losses))
    log(f"{tag} val F1 {val_f1:.6f}; history {tr.history}")

    # device busy and idle share over a 5-step epoch (same trainer, the
    # train split cut to 100 nodes), wall time from an unprofiled epoch
    tr.ds = dataclasses.replace(tr.ds, train_nodes=ds.train_nodes[:100])
    tr.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} 5-step epoch {wall:.6f} ms (warm, prefetch on)")
    profile_device(tr.train_epoch, wall, what="5-step epoch ms", top=12)
    tr.ds = ds
    return {"trainer": tr, "launches": launches,
            "ms_per_step": statistics.median(tail)}


# ------------------------------------------------------------ pair scores

def scores_row(label: str, emb: torch.Tensor, target_rows: torch.Tensor,
               launches: int) -> dict:
    """The pair-score kernel against its plain version (forward in float32
    and bfloat16, gradient through PairScores), and its kernel row."""
    got = sddmm.pair_scores_kernel(emb, target_rows)
    torch.cuda.synchronize()
    err = check_close(f"pair_scores {label}", got,
                      sddmm.dense_pair_scores(emb, target_rows),
                      bf16_atol=SCORES_BF16_ATOL)
    e16 = emb.bfloat16()
    err16 = check_close(f"pair_scores {label} bf16",
                        sddmm.pair_scores_kernel(e16, target_rows),
                        sddmm.dense_pair_scores(e16, target_rows),
                        bf16_atol=SCORES_BF16_ATOL)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(5)
                    ).to(emb.device)
    grads = []
    for fn in (sddmm.PairScores.apply, sddmm.dense_pair_scores):
        leaf = emb.detach().clone().requires_grad_(True)
        (fn(leaf, target_rows) * g).sum().backward()
        grads.append(leaf.grad)
    # bfloat16: both compute in float32 and round once; near 0 a float32
    # difference of the cancelling sums is many bf16 ulps
    grad_err = check_close(f"pair_scores {label} gradient", grads[0],
                           grads[1], bf16_atol=1e-5 * float(
                               grads[1].float().abs().max()))

    b, (u, h) = target_rows.shape[0], emb.shape
    es = emb.element_size()
    nbytes = u * h * es + b * 4 + b * u * es
    ops = 2 * b * u * h + 3 * (u + b) * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    t_long = target_rows.long()
    library = lambda: torch.mm(F.normalize(emb[t_long], eps=1e-8),
                               F.normalize(emb, eps=1e-8).T)
    library_err = float((library() - got).abs().max())
    row = {
        "name": f"pair_scores ({label})",
        "route": "cuda",
        "source": SCORE_SOURCE,
        "replaces": REPLACES["pair_scores"],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: sddmm.pair_scores_kernel(emb, target_rows),
                "pair_scores_kernel", library=library, reps=100),
        "plain_ms": cuda_ms(lambda: sddmm.dense_pair_scores(emb,
                                                            target_rows),
                            reps=50),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"kernel {row['name']}: emb {tuple(emb.shape)} stride "
        f"{emb.stride(0)} {emb.dtype}, {b} targets, {nbytes} bytes, {ops} "
        f"operations ({row['bound_by']}); {timing_note(row)} [torch.mm of "
        f"F.normalize'd rows, max abs diff to the kernel {library_err}] "
        f"max_abs_err {err} bf16 max_abs_err {err16} gradient max_abs_err "
        f"{grad_err}")
    return row


def score_rows(step_inputs: dict, launches: int, dev: torch.device) -> list:
    (emb, target_rows), = step_inputs["pair_scores"]
    rows = [scores_row(f"training step, {target_rows.shape[0]} x "
                       f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                       target_rows, launches)]
    rng = np.random.RandomState(11)
    big = torch.from_numpy(rng.randn(2048, 128).astype(np.float32)).to(dev)
    rows.append(scores_row("512 x 2048, H 128", big, torch.from_numpy(
        rng.randint(0, 2048, 512).astype(np.int32)).to(dev), launches))
    ragged = rng.randn(1000, 100).astype(np.float32)
    ragged[[0, 17, 999]] = 0.0
    t = rng.randint(0, 1000, 3).astype(np.int32)
    t[0] = 17                                      # a zero-norm target
    rows.append(scores_row("ragged 3 x 1000, H 100, zero rows",
                           torch.from_numpy(ragged).to(dev),
                           torch.from_numpy(t).to(dev), launches))
    return rows


def on_cpu(fn, *args):
    """fn on CPU copies of the tensors in args (the plain versions run)."""
    return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args))


def add_latency(dev: torch.device) -> float:
    """ns of one dependent bfloat16 add on this card: one warp's chain of
    2**20 add.rn.bf16x2, timed by clock64 and %globaltimer
    (gs_scatter_add_latency, csrc/scatter.cu), the second of two calls."""
    lib = build.load_library("scatter")
    one = torch.ones(2, dtype=torch.bfloat16).view(torch.int32).item()
    inp = torch.tensor([0, one], dtype=torch.int32, device=dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    n = 1 << 20
    for _ in range(2):
        rc = lib.gs_scatter_add_latency(
            dev.index or 0, inp.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gs_scatter_add_latency: CUDA error {rc}")
    torch.cuda.synchronize()
    cycles, ns, _ = out.tolist()
    log(f"bf16 add latency: a chain of {n} dependent add.rn.bf16x2 in "
        f"{cycles} cycles, {ns} ns: {cycles / n:.4f} cycles, {ns / n:.6f} ns "
        f"an add (SM clock {cycles / ns:.4f} GHz)")
    return ns / n


def scatter_row(label: str, g: torch.Tensor, idx: torch.Tensor, m: int,
                launches: int) -> dict:
    """scatter_rows against its plain version on the card and on the CPU
    (bit for bit: both add in JAX's order), and its kernel row: the bound
    is the larger of the bytes (g read once, since the zero test reads
    every row, the ids, the output written once) over the HBM rate and the
    chain of the longest row's dependent adds at ADD_NS each (bound_by
    "operations"); the library call is index_add_ of the same rows
    (bfloat16 atomics, in another order), the plain version the
    rank-by-rank adds on the card."""
    g, idx = g.contiguous(), idx.reshape(-1).int().contiguous()
    got = scatter.scatter_rows_kernel(g, idx, m)
    torch.cuda.synchronize()
    assert torch.equal(got, scatter.scatter_rows_plain(g, idx, m)), label
    assert torch.equal(got.cpu(), on_cpu(scatter.scatter_rows_plain, g, idx,
                                         m)), label
    nonzero = (g != 0).any(dim=1)
    chain = int(torch.bincount(idx[nonzero].long(), minlength=m).max())
    j, d = g.shape
    nbytes = j * d * 2 + j * 4 + m * d * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = chain * ADD_NS / 1e6
    long_idx = idx.long()
    row = {
        "name": f"scatter_rows ({label})",
        "route": "cuda",
        "source": SCATTER_SOURCE,
        "replaces": REPLACES["scatter_rows"],
        "launches": launches,
        "max_abs_err": 0.0,
        **times(lambda: scatter.scatter_rows_kernel(g, idx, m), None,
                library=lambda: torch.zeros(m, d, dtype=g.dtype,
                                            device=g.device).index_add_(
                                                0, long_idx, g), reps=20),
        "plain_ms": cuda_ms(lambda: scatter.scatter_rows_plain(g, idx, m),
                            reps=2, warmup=1),
        "bound_ms": max(bytes_ms, chain_ms),
        "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
        "bytes_ms": bytes_ms,
        "chain_ms": chain_ms,
    }
    log(f"kernel {row['name']}: g {tuple(g.shape)} {g.dtype} into [{m}, "
        f"{d}], {int(nonzero.sum())} nonzero rows, {nbytes} bytes "
        f"({bytes_ms:.6f} ms), the longest row {chain} adds ({chain_ms:.6f} "
        f"ms at {ADD_NS:.6f} ns an add); the whole call (memset, count, "
        f"place, sum) {timing_note(row)} [index_add_, bfloat16 atomics]; "
        f"equal to the plain version on the card and on the CPU")
    return row


def bf16_backward_check(name: str, fn, embed: torch.Tensor, args: tuple,
                        g: torch.Tensor) -> None:
    """The bfloat16 gradient of sum(fn(embed, *args) * g) through the
    kernels equals the same from CPU copies (the plain versions) bit for
    bit."""
    grads = []
    for dev in (embed.device, torch.device("cpu")):
        leaf = embed.detach().to(dev).clone().requires_grad_(True)
        (fn(leaf, *(a.to(dev) for a in args)).float()
         * g.to(dev).float()).sum().backward()
        grads.append(leaf.grad)
    if not torch.equal(grads[0].cpu(), grads[1]):
        raise AssertionError(f"{name}: the card's bf16 gradient differs "
                             f"from the CPU's")


def mean_step_rows(step_inputs: dict, launches: int,
                   what: str = "training",
                   scatter_launches: int | None = None) -> list:
    """gather_mean at the training step's two layer shapes: the kernel row,
    and the scatter-add gradient against autograd through the plain
    version (float32) or against the same gradient on the CPU (bfloat16,
    bit for bit), with a scatter_rows row at the backward's shape when
    ``scatter_launches`` is given."""
    rows = []
    for layer, (embed, idx, mask) in enumerate(step_inputs["gather_mean"],
                                               start=1):
        bf16 = embed.dtype == torch.bfloat16
        label = f"{'bf16' if bf16 else 'f32'} {what} layer {layer}"
        rows.append(kernel_row("gather_mean", label, embed, idx, mask,
                               launches))
        g = torch.randn(idx.shape[0], embed.shape[1],
                        generator=torch.Generator().manual_seed(layer)
                        ).to(embed.device, embed.dtype)
        if bf16:
            bf16_backward_check(f"gather_mean {label}", agg.mean_aggregate,
                                embed, (idx, mask), g)
            err = 0.0
        else:
            grads = []
            for fn in (agg.mean_aggregate, agg.mean_aggregate_plain):
                leaf = embed.detach().clone().requires_grad_(True)
                (fn(leaf, idx, mask).float() * g.float()).sum().backward()
                grads.append(leaf.grad)
            err = check_close(f"gather_mean {label} gradient", grads[0],
                              grads[1])
        bwd = lambda: agg.mean_aggregate_backward(g, idx, mask, embed.shape,
                                                  embed.dtype)
        leaf = embed.detach().clone().requires_grad_(True)
        plain_out = agg.mean_aggregate_plain(leaf, idx, mask)
        plain_bwd = lambda: torch.autograd.grad(plain_out, leaf, g,
                                                retain_graph=True)
        against = ("equal to the CPU's bit for bit" if bf16 else
                   "max_abs_err against autograd through the plain version")
        log(f"  gather_mean {label} backward (scatter-add into "
            f"{list(embed.shape)}): {against} {err}; "
            f"{cuda_ms(bwd, reps=20):.6f} ms, device {device_ms(bwd):.6f} "
            f"ms; plain (autograd) device {device_ms(plain_bwd):.6f} ms")
        if bf16 and scatter_launches is not None:
            w = (mask / mask.sum(1, keepdim=True).clamp_min(1.0)).to(g.dtype)
            rows.append(scatter_row(
                f"{label} backward, {idx.numel()} rows into "
                f"{list(embed.shape)}",
                (g[:, None, :] * w[:, :, None]).reshape(-1, embed.shape[1]),
                idx, embed.shape[0], scatter_launches))
    return rows


def max_backward_row(label: str, embed: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor, launches: int) -> dict:
    """gather_max's backward (agg.max_aggregate_backward: the tie gather
    through the gather_rows kernel, the tie test, the division and the
    scatter) against autograd through the plain version (bfloat16: against
    the same composition on the CPU, bit for bit), and its row:
    the composition's time beside its byte bound and the plain backward's
    time (no one PyTorch call computes it: library_ms is null)."""
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(11)
                    ).to(embed.device, embed.dtype)
    with torch.no_grad():
        out = agg.max_aggregate(embed, idx, mask)
    got = agg.max_aggregate_backward(g, embed, idx, mask, out)
    leaf = embed.detach().clone().requires_grad_(True)
    plain_out = agg.max_aggregate_plain(leaf, idx, mask)
    torch.cuda.synchronize()
    if embed.dtype == torch.bfloat16:
        # JAX's order of the bfloat16 adds: the CPU's result, bit for bit
        want = on_cpu(agg.max_aggregate_backward, g, embed, idx, mask, out)
        assert torch.equal(got.cpu(), want), label
        err = 0.0
    else:
        want, = torch.autograd.grad(plain_out, leaf, g, retain_graph=True)
        err = check_close(f"gather_max backward {label}", got, want)

    (u, s), (m, d) = idx.shape, embed.shape
    es = embed.element_size()
    rows_read = int(torch.unique(idx).numel())
    nbytes = (2 * u * d * es + 2 * u * s * 4 + rows_read * d * es
              + m * d * es)
    row = {
        "name": f"gather_max backward ({label})",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": REPLACES["gather_max"],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: agg.max_aggregate_backward(g, embed, idx, mask, out),
                None, reps=20),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(
            plain_out, leaf, g, retain_graph=True), reps=20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "library_device_ms": None,
    }
    log(f"kernel {row['name']}: embed {tuple(embed.shape)} {embed.dtype}, "
        f"idx {tuple(idx.shape)}, {rows_read} rows read, {nbytes} bytes; "
        f"the whole composition (gather_rows, tie test, scatter into "
        f"[{m}, {d}]) {timing_note(row)} [plain: autograd through "
        f"max_aggregate_plain's amax] max_abs_err {err}")
    return row


def max_step_rows(step_inputs: dict, launches: dict) -> list:
    """gather_max at the compact MAX step's two layer shapes (forward,
    exact) and its backward at both; only layer 2's runs in training (layer
    1 aggregates constant feature rows), so layer 1's backward row counts 0
    launches."""
    rows = []
    for layer, (embed, idx, mask) in enumerate(step_inputs["gather_max"],
                                               start=1):
        dtype = "bf16" if embed.dtype == torch.bfloat16 else "f32"
        label = f"{dtype} compact layer {layer}"
        rows.append(kernel_row("gather_max", label, embed, idx, mask,
                               launches["gather_max"]))
        rows.append(max_backward_row(
            f"{label}, idx {list(idx.shape)} over {list(embed.shape)}",
            embed, idx, mask, launches["gather_rows"] if layer > 1 else 0))
    return rows


def lstm_step_rows(step_inputs: dict, launches: dict) -> list:
    """gather_rows at the compact LSTM step's layer-1 slot gather."""
    (table, idx), _ = step_inputs["gather_rows"]
    return [gather_row(f"compact LSTM layer-1 slots, {idx.shape[0]} ids "
                       f"over {list(table.shape)}", table, idx,
                       launches["gather_rows"])]


# ------------------------------------------------------------ cached training

# (label, learn_method, agg_func, gcn, b_sz, extend_batches, train nodes
#  kept (None: the whole split), epochs, refresh_every)
CACHED_CONFIGS = (
    ("a", "sup", "MEAN", False, 32768, False, None, 3, 2),
    ("b", "sup", "MAX", True, 512, False, 5120, 1, 1),
    ("c", "plus_unsup", "MEAN", False, 20, True, 1000, 1, 1),
    ("d", "sup", "LSTM", False, 32768, False, None, 2, 1),
)
TABLE_CAP = 32
TIMED_STEPS = 20


class RecordingHop:
    """The trainer's hop sampler, with every draw kept in order."""

    def __init__(self, hop):
        self.hop = hop
        self.draws = []

    def __call__(self, nodes, fanout):
        out = self.hop(nodes, fanout)
        self.draws.append(out)
        return out


class ReplayHop:
    """Gives back recorded draws in order (the plain run's sampler)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, nodes, fanout):
        samples, valid = self.draws.pop(0)
        assert samples.shape == (nodes.shape[0], fanout), samples.shape
        return samples, valid


@contextlib.contextmanager
def plain_cached():
    """The cached pipeline through the plain versions on the card."""
    with patched(cached, gather_rows=gather.gather_rows_plain,
                 mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain), \
            patched(sddmm, pair_scores=sddmm.dense_pair_scores):
        yield


def predicted_launches(tr: CachedTrainer, records: list,
                       epochs: int) -> dict:
    """What the code launches in the counted fit: per refresh one
    gather_mean / gather_max launch; per step one gather_rows launch on the
    full-table branch and two per occurrence, by cached.layer1_full_table
    at the step's m1; one pair_scores per unsupervised step whose score
    block sddmm.dense_block_pays picks; per evaluation embedding (val, and
    test when val F1 improved) one refresh and the layer-1 gathers at
    m1 = bucket(nodes) x (K + 1); in bfloat16 one scatter_rows a step on
    the full-table branch (the other gathers read constant tables)."""
    k = tr.tcfg.fanout

    def rows_at(m1):
        return 1 if cached.layer1_full_table(NODES, FEATS, m1, HIDDEN) else 2

    every = tr.tcfg.refresh_every
    refreshes = sum(1 for ep in range(epochs) if ep % every == 0)
    want = {"gather_mean": 0, "gather_max": 0, "pair_scores": 0,
            "gather_rows": 0, "scatter_rows": 0}
    bf16 = tr.mcfg.compute_dtype == "bfloat16"
    for rec in records:
        batch, _, _, pairs = rec["args"]
        want["gather_rows"] += rows_at(batch.shape[0] * (k + 1))
        full = rows_at(batch.shape[0] * (k + 1)) == 1
        want["scatter_rows"] += int(bf16 and full)
        if pairs is not None:
            b, u = pairs["target_rows"].shape[0], batch.shape[0]
            n_pairs = pairs["pos_q"].numel() + pairs["neg_q"].numel()
            want["pair_scores"] += sddmm.dense_block_pays(b, u, n_pairs,
                                                          HIDDEN)
    for entry in tr.history:
        for nodes, key in ((tr.ds.val_nodes, "val_f1"),
                           (tr.ds.test_nodes, "test_f1")):
            if key in entry:
                refreshes += 1
                want["gather_rows"] += rows_at(_bucket(len(nodes)) * (k + 1))
    want["gather_max" if tr.mcfg.agg_func == "MAX" else "gather_mean"] = (
        refreshes)
    return want


def gather_row(label: str, table: torch.Tensor, idx: torch.Tensor,
               launches: int) -> dict:
    """gather_rows against index_select (exact), and its kernel row."""
    got = gather.gather_rows_kernel(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_rows_plain(table, idx)), label
    j, d = idx.shape[0], table.shape[1]
    es = table.element_size()
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * d * es + j * 4 + j * d * es
    row = {
        "name": f"gather_rows ({label})",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": REPLACES["gather_rows"],
        "launches": launches,
        "max_abs_err": 0.0,
        **times(lambda: gather.gather_rows_kernel(table, idx),
                "gather_rows_kernel",
                library=lambda: table.index_select(0, idx)),
        "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(table, idx),
                            reps=50),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    log(f"kernel {row['name']}: table {tuple(table.shape)} stride "
        f"{table.stride(0)} {table.dtype}, {j} ids, {rows_read} rows read, "
        f"{nbytes} bytes ({nbytes / row['device_ms'] / 1e9:.3f} TB/s of "
        f"device time); {timing_note(row)} [index_select with the int32 "
        f"ids]; equal to index_select")
    return row


def cached_config(label: str, method: str, agg_func: str, gcn: bool,
                  b_sz: int, extend: bool, keep, epochs: int, every: int,
                  ds, dev: torch.device) -> dict:
    """One cached configuration: the counted fit, its predicted launches,
    the lockstep check against the plain versions, the refresh against
    its plain version, refresh_ms, ms_per_step, the device profile of one
    epoch and val F1.  LSTM is the cached-LSTM hybrid: its layer-0 cell
    must come out of the fit unchanged, and the trained model is exported
    as a bundle for the hybrid's serving phase."""
    if keep is not None:
        ds = dataclasses.replace(ds, train_nodes=ds.train_nodes[:keep])
    hybrid = agg_func == "LSTM"
    tag = (f"[cached {label}: {method} {agg_func}"
           f"{' hybrid' if hybrid else ''}{' gcn' if gcn else ''} "
           f"b_sz {b_sz}{' extended' if extend else ''}]")
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=agg_func, gcn=gcn)
    tcfg = TrainConfig(learn_method=method, unsup_loss="normal",
                       epochs=epochs, b_sz=b_sz, lr=LR, fanout=FANOUT,
                       seed=SEED, verbose=False, refresh_every=every)
    t0 = time.perf_counter()
    tr = CachedTrainer(ds, cfg, tcfg, table_cap=TABLE_CAP,
                       extend_batches=extend, lstm_hybrid=hybrid, device=dev)
    log(f"{tag} trainer: {len(ds.train_nodes)} train nodes, table "
        f"{tuple(tr.neighbors.shape)}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    cells = ([{k: v.detach().clone() for k, v in cell.items()}
              for cell in tr.params["sage"]["agg"]] if hybrid else None)

    # -------- the main path, counted and recorded
    step, refresh, hop = tr._step, tr._refresh, RecordingHop(tr.hop)
    records, refreshes = [], []

    def recording_step(params, feats, cache_feats, cache_count, hop_, *args):
        before = param_snapshot(tr)
        first = len(hop.draws)
        loss = step(params, feats, cache_feats, cache_count, hop_, *args)
        records.append({"before": before, "after": param_snapshot(tr),
                        "cache": (cache_feats, cache_count), "args": args,
                        "draws": hop.draws[first:], "loss": loss})
        return loss

    def recording_refresh():
        first = len(hop.draws)
        out = refresh()
        refreshes.append({"draws": hop.draws[first:], "cache": out})
        return out

    tr._step, tr._refresh, tr.hop = recording_step, recording_refresh, hop
    agg.reset_launches()
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    tr._step, tr._refresh, tr.hop = step, refresh, hop.hop
    steps = len(records)
    assert steps == epochs * -(-len(ds.train_nodes) // b_sz), steps
    want = predicted_launches(tr, records, epochs)
    log(f"{tag} main path: CachedTrainer.fit, {epochs} epochs of "
        f"{steps // epochs} steps, {len(refreshes)} refreshes (evaluation "
        f"included) in {fit_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}")
    assert launches == want, (launches, want)
    losses = np.asarray([float(r["loss"]) for r in records])
    assert np.isfinite(losses).all()
    bundle = None
    if hybrid:
        for k, v in tr.params["sage"]["agg"][0].items():
            assert torch.equal(v.detach(), cells[0][k]), k
        assert not torch.equal(tr.params["sage"]["agg"][1]["w_ih"].detach(),
                               cells[1]["w_ih"])
        bundle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke_bundles",
                              f"cached_{label}_hybrid")
        infer.export_bundle(bundle, params_to_numpy(tr.params), cfg, CLASSES,
                            meta={"lstm_hybrid": True})
        log(f"{tag} the layer-0 cell is unchanged after the fit (the "
            f"layer-2 cell trained); exported the hybrid to {bundle}")

    # -------- the refresh against its plain version, same samples
    first = refreshes[0]
    with plain_cached():
        ref_feats, ref_cnt = cached.refresh_leaf_cache(
            ReplayHop(first["draws"]), tr.feats, FANOUT, agg=agg_func)
    got_feats, got_cnt = first["cache"]
    err = check_close(f"{tag} refresh vs plain", got_feats, ref_feats,
                      exact=agg_func == "MAX")
    assert torch.equal(got_cnt, ref_cnt)
    log(f"{tag} refresh vs {'max' if agg_func == 'MAX' else 'mean'}"
        f"_aggregate_plain on the same samples: max abs error {err}; counts "
        f"equal")

    # -------- lockstep: each plain step from the kernel run's params,
    # cache and draws of that step
    ref = _leaf_params(tr.params, dev)
    loss_rel, param_err = [], []
    agg.reset_launches()
    with plain_cached():
        for rec in records:
            with torch.no_grad():
                for p, q in zip(tree_leaves(ref), rec["before"]):
                    p.copy_(q)
            loss = step(ref, tr.feats, *rec["cache"],
                        ReplayHop(rec["draws"]), *rec["args"])
            loss_rel.append(abs(float(loss) - float(rec["loss"]))
                            / abs(float(rec["loss"])))
            param_err.append(max_abs_diff(tree_leaves(ref), rec["after"]))
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    log(f"{tag} lockstep, kernels vs plain versions over {steps} steps: "
        f"loss max relative difference {max(loss_rel):.3e} (tolerance "
        f"{LOSS_RTOL}); params after each step max abs difference "
        f"{max(param_err):.3e} (tolerance {PARAM_ATOL})")
    assert max(loss_rel) <= LOSS_RTOL and max(param_err) <= PARAM_ATOL
    del ref

    # -------- refresh_ms and ms_per_step on one cache
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refresh_ms = statistics.median(times)
    log(f"{tag} refresh_ms {refresh_ms:.6f} (median of 5; min "
        f"{min(times):.6f}, max {max(times):.6f})")
    cache = tr._stale_cache
    last = [rec["args"] for rec in records[-(steps // epochs):]]
    times = []
    for i in range(TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tr.params, tr.feats, *cache, tr.hop, *last[i % len(last)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[2:]
    ms_per_step = statistics.median(times)
    log(f"{tag} ms_per_step {ms_per_step:.6f} (median of {len(times)} "
        f"steps on one cache; min {min(times):.6f}, max {max(times):.6f}); "
        f"fit loss curve " + " ".join(f"{x:.6f}" for x in losses))

    # -------- the gathers and the score block one step makes, for the
    # kernel rows
    seen, scores_seen = [], []

    def gather_rec(table, idx):
        seen.append((table.detach(), idx))
        return gather.gather_rows(table, idx)

    def scores_rec(emb, target_rows, eps=1e-8):
        scores_seen.append((emb.detach(), target_rows))
        return sddmm.PairScores.apply(emb, target_rows, eps)

    with patched(cached, gather_rows=gather_rec), \
            patched(sddmm, pair_scores=scores_rec):
        step(tr.params, tr.feats, *cache, tr.hop, *last[0])
    torch.cuda.synchronize()
    batch, _, _, pairs = last[0]
    if launches["pair_scores"]:
        # B and U as predicted_launches reads them from the step
        (emb, target_rows), = scores_seen
        assert (target_rows.shape[0], emb.shape[0]) == (
            pairs["target_rows"].shape[0], batch.shape[0])

    # -------- device profile of one epoch (with its refresh)
    tr.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} one epoch {wall:.6f} ms (warm, host batch building and "
        f"the refresh included)")
    profile_device(tr.train_epoch, wall, what="epoch ms", top=12)
    val_f1 = tr.history[-1]["val_f1"]
    log(f"{tag} val F1 {val_f1:.6f}; history {tr.history}")
    return {"label": label, "launches": launches, "refresh": first,
            "gathers": seen, "scores": scores_seen, "feats": tr.feats,
            "bundle": bundle,
            "summary": {"refresh_ms": refresh_ms, "ms_per_step": ms_per_step,
                        "val_f1": val_f1, "steps": steps}}


def cached_rows(results: dict) -> list:
    """gather_mean / gather_max at the refresh shape, gather_rows at (a)'s
    full-table and (b)'s per-occurrence shapes, pair_scores at (c)'s step
    shape."""
    rows = []
    for label, name in (("a", "gather_mean"), ("b", "gather_max")):
        res = results[label]
        (samples, valid), = res["refresh"]["draws"]
        own = torch.arange(NODES, dtype=torch.int32, device=samples.device)
        mask = (valid & (samples != own[:, None])).float()
        rows.append(kernel_row(name, f"f32 refresh ({label}), idx "
                               f"[{NODES}, {FANOUT}] over [{NODES}, {FEATS}]",
                               res["feats"], samples, mask,
                               res["launches"][name]))
    for label, what in (("a", "full table"), ("b", "per occurrence")):
        res = results[label]
        table, idx = res["gathers"][0]
        rows.append(gather_row(f"cached ({label}) {what}, {idx.shape[0]} ids "
                               f"over {list(table.shape)}", table, idx,
                               res["launches"]["gather_rows"]))
    (emb, target_rows), = results["c"]["scores"]
    rows.append(scores_row(f"cached (c) step, {target_rows.shape[0]} x "
                           f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                           target_rows,
                           results["c"]["launches"]["pair_scores"]))
    return rows


# ------------------------------------------------------------ bfloat16 training

# (label, agg_func, b_sz, steps): the JAX bench's bfloat16 cached rows
# (bench.py:278-289), sup on bench-style batches; (h) and (i) run fewer
# steps than (e) to keep the run short
BF16_CACHED = (("e", "MEAN", 65536, 20), ("h", "MAX", 32768, 10),
               ("i", "LSTM", 32768, 5))
DENSE_B, DENSE_STEPS = 4096, 20


def bf16_config(agg_func: str = "MEAN") -> GraphSageConfig:
    return GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                           agg_func=agg_func, compute_dtype="bfloat16")


def bf16_params(cfg: GraphSageConfig, dev: torch.device) -> dict:
    """float32 master params from a torch.Generator seeded with SEED."""
    gen = torch.Generator().manual_seed(SEED)
    return _leaf_params({"sage": init_graphsage(gen, cfg),
                         "clf": init_classifier(gen, HIDDEN, CLASSES)}, dev)


def bench_batches(b: int, steps: int, labels: torch.Tensor):
    """The JAX bench's batch stack (bench.py _setup):
    RandomState(0).randint(0, N, (steps, b)), and its labels."""
    ids = np.random.RandomState(0).randint(0, NODES, (steps, b))
    batches = torch.from_numpy(ids.astype(np.int32)).to(labels.device)
    return batches, labels[batches.long()]


class SnapshotHop(RecordingHop):
    """A RecordingHop that also snapshots ``params`` at the first hop of
    every step (a step samples before it updates anything)."""

    def __init__(self, hop, params, hops_a_step: int):
        super().__init__(hop)
        self.params = params
        self.every = hops_a_step
        self.snaps = []

    def __call__(self, nodes, fanout):
        if len(self.draws) % self.every == 0:
            self.snaps.append(snapshot(self.params))
        return super().__call__(nodes, fanout)


def replay_lockstep(tag: str, step, params: dict, records: list, plain,
                    args_of) -> None:
    """Each recorded step again through the plain versions, from the kernel
    run's params before that step and on its draws (``args_of(rec)``: the
    step's arguments after the params); bfloat16 lockstep tolerances."""
    ref = _leaf_params(params, params["clf"]["weight"].device)
    loss_rel, abs_errs, upd_errs = [], [], []
    agg.reset_launches()
    with plain():
        for rec in records:
            with torch.no_grad():
                for p, q in zip(tree_leaves(ref), rec["before"]):
                    p.copy_(q)
            loss = float(step(ref, *args_of(rec)))
            loss_rel.append(abs(loss - float(rec["loss"]))
                            / abs(float(rec["loss"])))
            got = tree_leaves(ref)
            abs_errs.append(max_abs_diff(got, rec["after"]))
            upd_errs.append(update_error(got, rec["after"], rec["before"]))
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    assert_lockstep(tag, "bfloat16", loss_rel, abs_errs, upd_errs)


def timed_steps(tag: str, run_step, steps: int, edges: int) -> float:
    """ms_per_step over TIMED_STEPS synchronised steps (after two warm
    ones), with min, max and edges/s; returns the median."""
    times = []
    for i in range(TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(i % steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[2:]
    ms = statistics.median(times)
    log(f"{tag} ms_per_step {ms:.6f} (median of {len(times)} steps; min "
        f"{min(times):.6f}, max {max(times):.6f}); edges_per_batch {edges}, "
        f"{edges / ms * 1e3:.1f} edges/s")
    return ms


def epoch_profile(tag: str, epoch, steps: int) -> float:
    """A warm epoch's wall time (host clock, synchronised) and the device
    profile of another; returns the wall ms."""
    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} one epoch of {steps} steps {wall:.6f} ms ({wall / steps:.6f} "
        f"ms a step, no synchronisation inside)")
    profile_device(epoch, wall, what="epoch ms", top=12)
    return wall


def upcast_costs(tag: str, table: torch.Tensor, w: torch.Tensor) -> None:
    """Device time of the float32 upcast of a bfloat16 table and of the
    float32 GEMM the port takes on it (TF32 off), beside a bfloat16
    tensor-core GEMM of the same operands, which the port does not run."""
    up = device_ms(lambda: table.float())
    t32, w32 = table.float(), w.float()
    gemm = device_ms(lambda: torch.matmul(t32, w32.T))
    gemm16 = device_ms(lambda: torch.matmul(table, w.T))
    ops = 2 * table.shape[0] * table.shape[1] * w.shape[0]
    bound = ops / F32_OPS_PER_S * 1e3
    log(f"{tag} upcast of the bf16 table {list(table.shape)} to float32: "
        f"{up:.6f} ms device ({table.numel() * 6 / up / 1e9:.3f} TB/s); "
        f"float32 GEMM x {list(w.shape)}^T {gemm:.6f} ms device "
        f"({ops / gemm / 1e9:.1f} TFLOP/s, bound {bound:.6f} ms); a bf16 "
        f"GEMM of the same operands (not run by the port) {gemm16:.6f} ms "
        f"device")


def scatter_deviation(tag: str, g: torch.Tensor, idx: torch.Tensor,
                      m: int) -> None:
    """The layer-1 gather's bf16 backward, d_table = the scatter-add of g
    [J, D] into [m, D], against the float64 sum of the same contributions:
    the port's (scatter_rows, JAX's order; the CPU's plain version equals
    it bit for bit, see scatter_row), index_add_'s bfloat16 atomics on the
    card (not run by the port) and a float32 index_add_ on the card."""
    exact = torch.zeros(m, g.shape[1], dtype=torch.float64,
                        device=g.device).index_add_(0, idx.long(),
                                                    g.double())
    # contributions that are not all zero (masked slots, such as the
    # sampler's padding ids, send zero rows)
    counts = torch.bincount(idx[(g != 0).any(dim=1)].long(), minlength=m)
    hub = int(counts.argmax())
    scale = float(exact.abs().max())
    hub_scale = float(exact[hub].abs().max())
    zeros = torch.zeros(m, g.shape[1], dtype=g.dtype, device=g.device)
    outs = {"card bf16 (scatter_rows, JAX's order)":
            scatter.scatter_rows(g, idx, m),
            "card bf16 (index_add_ atomics)":
            zeros.index_add_(0, idx.long(), g),
            "card float32": scatter.scatter_rows(g.float(), idx, m)}
    busy = counts >= 256
    for name, d in outs.items():
        dev = (d.double() - exact).abs()
        busy_dev = float(dev[busy].max()) if busy.any() else 0.0
        log(f"{tag} bf16 scatter of {idx.shape[0]} rows into [{m}, "
            f"{g.shape[1]}]: {name}: max abs deviation from the float64 sum "
            f"{float(dev.max()):.6e} ({float(dev.max()) / scale:.3e} of the "
            f"largest |sum|); hub row {hub} ({int(counts[hub])} nonzero "
            f"contributions): {float(dev[hub].max()):.6e} "
            f"({float(dev[hub].max()) / hub_scale:.3e} of its largest "
            f"|sum|); {int(busy.sum())} rows with >= 256 nonzero "
            f"contributions, "
            f"their max deviation {busy_dev:.6e}")


def bf16_cached(label: str, agg_func: str, b: int, steps: int, feats16,
                tables, labels, dev: torch.device) -> dict:
    """A bfloat16 cached configuration on the library path the JAX bench
    times (refresh, then cached_epoch_reuse over bench batches): the
    counted epoch, its predicted launches, the refresh and every step
    against the plain versions on the recorded draws, refresh_ms,
    ms_per_step, edges/s, the epoch's idle share, and one more step whose
    layer-1 gather and its incoming gradient are kept for the kernel rows
    and the scatter deviation."""
    cfg = bf16_config(agg_func)
    hybrid = agg_func == "LSTM"
    tag = (f"[bf16 cached {label}: sup {agg_func}{' hybrid' if hybrid else ''}"
           f" b_sz {b}]")
    params = bf16_params(cfg, dev)
    batches, batch_labels = bench_batches(b, steps, labels)
    hop = RecordingHop(HopSampler(*tables, torch.Generator(
        device=dev).manual_seed(SEED + 1)))
    step = cached.CachedStep(cfg, fanout=FANOUT, lr=LR)
    records = []

    def recording_step(params_, feats, cache_feats, cache_count, hop_,
                       *args):
        before, first = snapshot(params_), len(hop.draws)
        loss = step(params_, feats, cache_feats, cache_count, hop_, *args)
        records.append({"before": before, "after": snapshot(params_),
                        "args": args, "draws": hop.draws[first:],
                        "loss": loss})
        return loss

    # -------- the main path, counted
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
    refresh_draws = list(hop.draws)
    losses = cached.cached_epoch_reuse(recording_step, params, feats16,
                                       *cache, hop, batches, batch_labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    full = cached.layer1_full_table(NODES, FEATS, b * (FANOUT + 1), HIDDEN)
    want = {"gather_mean": int(agg_func != "MAX"),
            "gather_max": int(agg_func == "MAX"), "pair_scores": 0,
            "gather_rows": steps * (1 if full else 2),
            "scatter_rows": steps * int(full)}
    log(f"{tag} main path: refresh_leaf_cache + cached_epoch_reuse, "
        f"{steps} steps in {run_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}; loss curve "
        + " ".join(f"{x:.6f}" for x in losses.tolist()))
    assert launches == want, (launches, want)
    assert cache[0].dtype == torch.bfloat16
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))

    # -------- the refresh and every step against the plain versions
    with plain_cached():
        ref_f, ref_c = cached.refresh_leaf_cache(
            ReplayHop(refresh_draws), feats16, FANOUT, agg=agg_func)
    err = check_close(f"{tag} refresh vs plain", cache[0], ref_f,
                      exact=agg_func == "MAX")
    assert torch.equal(cache[1], ref_c)
    log(f"{tag} refresh vs plain on the same samples: max abs error {err}")
    replay_lockstep(tag, step, params, records, plain_cached,
                    lambda rec: (feats16, *cache, ReplayHop(rec["draws"]),
                                 *rec["args"]))
    del records

    # -------- refresh_ms, ms_per_step, the epoch's idle share
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refresh_ms = statistics.median(times)
    log(f"{tag} refresh_ms {refresh_ms:.6f} (median of 5; min "
        f"{min(times):.6f}, max {max(times):.6f})")
    edges = dense.edges_per_batch(b, 2, FANOUT)
    ms = timed_steps(tag, lambda t: step(params, feats16, *cache, hop,
                                         batches[t], batch_labels[t]),
                     steps, edges)

    def epoch():
        c = cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
        return cached.cached_epoch_reuse(step, params, feats16, *c, hop,
                                         batches, batch_labels)

    wall = epoch_profile(tag, epoch, steps)

    # -------- one more step, its layer-1 gather and incoming gradient kept
    seen = []

    def gather_rec(table, idx):
        out = gather.gather_rows(table, idx)
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(
                (table.detach(), idx, g.detach())))
        return out

    with patched(cached, gather_rows=gather_rec):
        step(params, feats16, *cache, hop, batches[0], batch_labels[0])
    torch.cuda.synchronize()
    table, idx, g = seen[0]
    assert g.dtype == torch.bfloat16 and idx.shape[0] == b * (FANOUT + 1)
    return {"label": label, "agg": agg_func, "launches": launches,
            "cache": cache, "refresh_draws": refresh_draws, "params": params,
            "gather": (table, idx, g),
            "summary": {"refresh_ms": refresh_ms, "ms_per_step": ms,
                        "edges_per_s": edges / ms * 1e3, "epoch_ms": wall,
                        "steps": steps}}


def bf16_dense(feats16, tables, labels, dev: torch.device) -> dict:
    """(f) the dense pipeline, sup MEAN bfloat16, batches of DENSE_B:
    make_dense_sup_epoch counted over DENSE_STEPS bench batches, every step
    against the plain versions on its recorded draws, ms_per_step, edges/s,
    the epoch's idle share, and one more step's gather_mean inputs for the
    kernel rows."""
    cfg = bf16_config()
    tag = f"[bf16 dense f: sup MEAN b_sz {DENSE_B}]"
    params = bf16_params(cfg, dev)
    batches, batch_labels = bench_batches(DENSE_B, DENSE_STEPS, labels)
    hop = SnapshotHop(HopSampler(*tables, torch.Generator(
        device=dev).manual_seed(SEED + 1)), params, cfg.num_layers)
    epoch = dense.make_dense_sup_epoch(cfg, fanout=FANOUT, lr=LR)
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = epoch(params, feats16, hop, batches, batch_labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    # one gather_mean a MEAN layer a step, whichever layer form
    k = FANOUT + 1
    want = {"gather_mean": cfg.num_layers * DENSE_STEPS, "gather_max": 0,
            "pair_scores": 0, "gather_rows": 0,
            "scatter_rows": DENSE_STEPS * bf16_scatters(
                cfg, NODES, DENSE_B * k * k, [DENSE_B * k, DENSE_B])}
    log(f"{tag} main path: make_dense_sup_epoch, {DENSE_STEPS} steps in "
        f"{run_s:.3f} s; launches {launches}; predicted from the code "
        f"{want}; loss curve " + " ".join(f"{x:.6f}" for x in
                                          losses.tolist()))
    assert launches == want, (launches, want)
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    snaps = hop.snaps + [snapshot(params)]
    k = cfg.num_layers
    records = [{"before": snaps[t], "after": snaps[t + 1],
                "loss": losses[t], "draws": hop.draws[k * t:k * (t + 1)],
                "args": (batches[t], batch_labels[t])}
               for t in range(DENSE_STEPS)]
    step = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=LR)
    replay_lockstep(tag, step, params, records, plain_training,
                    lambda rec: (feats16, ReplayHop(rec["draws"]),
                                 *rec["args"]))
    del records, snaps
    hop = hop.hop
    edges = dense.edges_per_batch(DENSE_B, 2, FANOUT)
    ms = timed_steps(tag, lambda t: step(params, feats16, hop, batches[t],
                                         batch_labels[t]),
                     DENSE_STEPS, edges)
    wall = epoch_profile(tag, lambda: epoch(params, feats16, hop, batches,
                                            batch_labels), DENSE_STEPS)
    seen = []

    def mean_rec(embed, idx, mask):
        seen.append((embed.detach(), idx, mask))
        return agg.mean_aggregate(embed, idx, mask)

    with patched(graphsage, mean_aggregate=mean_rec):
        step(params, feats16, hop, batches[0], batch_labels[0])
    torch.cuda.synchronize()
    return {"launches": launches, "params": params, "inputs": seen,
            "summary": {"ms_per_step": ms, "edges_per_s": edges / ms * 1e3,
                        "epoch_ms": wall, "steps": DENSE_STEPS}}


def bf16_phase(ds, train_ds, dev: torch.device, phase_mark) -> list:
    """Phase 9: bfloat16 training at full width, (e)-(i); returns the
    bfloat16 kernel rows."""
    log(f"bf16: torch.backends.cuda.matmul."
        f"allow_bf16_reduced_precision_reduction is "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f" (set False when graphsage_torch.models is imported)")
    feats16 = torch.from_numpy(ds.features).to(dev, torch.bfloat16)
    pad = ds.graph.to_padded_sampled(TABLE_CAP,
                                     np.random.RandomState(SEED))
    tables = (torch.from_numpy(pad.neighbors).to(dev),
              torch.from_numpy(pad.degrees).to(dev))
    labels = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)
    rows, summaries = [], {}

    results = {}
    for label, agg_func, b, steps in BF16_CACHED:
        res = results[label] = bf16_cached(label, agg_func, b, steps,
                                           feats16, tables, labels, dev)
        summaries[label] = res["summary"]
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    e = results["e"]
    w1 = dense.cast_compute(e["params"]["sage"]["layers"][0]["weight"],
                            bf16_config())
    upcast_costs("[bf16 cached e]",
                 torch.cat([feats16, e["cache"][0]], dim=-1), w1)
    table, idx, g = e["gather"]
    scatter_deviation("[bf16 cached e]", g, idx, table.shape[0])
    for label, name in (("e", "gather_mean"), ("h", "gather_max")):
        res = results[label]
        (samples, valid), = res["refresh_draws"]
        own = torch.arange(NODES, dtype=torch.int32, device=dev)
        mask = (valid & (samples != own[:, None])).float()
        rows.append(kernel_row(name, f"bf16 refresh ({label}), idx [{NODES}, "
                               f"{FANOUT}] over [{NODES}, {FEATS}]", feats16,
                               samples, mask, res["launches"][name]))
    for label in ("e", "h", "i"):
        res = results[label]
        table, idx, g = res["gather"]
        rows.append(gather_row(f"bf16 cached ({label}) full table, "
                               f"{idx.shape[0]} ids over {list(table.shape)}",
                               table, idx, res["launches"]["gather_rows"]))
        rows.append(scatter_row(f"bf16 cached ({label}) layer-1 backward, "
                                f"{idx.shape[0]} rows into "
                                f"{list(table.shape)}", g, idx,
                                table.shape[0],
                                res["launches"]["scatter_rows"]))
    del results, e, table, idx, g
    phase_mark("phase 9 (e), (h), (i): bf16 cached")

    f = bf16_dense(feats16, tables, labels, dev)
    summaries["f"] = f["summary"]
    # the pretransform's [2H, D] stack of the layer-1 weight's halves
    w1 = dense.cast_compute(f["params"]["sage"]["layers"][0]["weight"],
                            bf16_config())
    upcast_costs("[bf16 dense f]", feats16,
                 torch.cat([w1[:, :FEATS], w1[:, FEATS:]]))
    rows.extend(mean_step_rows({"gather_mean": f["inputs"]},
                               f["launches"]["gather_mean"], what="dense",
                               scatter_launches=f["launches"]["scatter_rows"]))
    del f
    phase_mark("phase 9 (f): bf16 dense")

    unsup = train_method("plus_unsup", train_ds, dev, free_running=False,
                         dtype="bfloat16")
    summaries["g"] = {"ms_per_step": unsup["ms_per_step"]}
    step_inputs = capture_step_inputs(unsup["trainer"])
    rows.extend(mean_step_rows(
        step_inputs, unsup["launches"]["gather_mean"],
        scatter_launches=unsup["launches"]["scatter_rows"]))
    (emb, target_rows), = step_inputs["pair_scores"]
    assert emb.dtype == torch.bfloat16
    rows.append(scores_row(f"bf16 training step, {target_rows.shape[0]} x "
                           f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                           target_rows, unsup["launches"]["pair_scores"]))
    del unsup, step_inputs
    phase_mark("phase 9 (g): bf16 compact plus_unsup")

    # (j) compact sup MAX gcn: gather_max forward, and layer 2's backward
    # composition (the tie gather through gather_rows, the tie test in
    # bfloat16, scatter_rows)
    res = train_method("sup", train_ds, dev, "MAX", True, free_running=False,
                       dtype="bfloat16")
    summaries["j"] = {"ms_per_step": res["ms_per_step"]}
    rows.extend(max_step_rows(capture_step_inputs(res["trainer"]),
                              res["launches"]))
    log(json.dumps({"bf16": summaries}))
    return rows


def microbench_rows(dev: torch.device, launches: int) -> list:
    """Phase 8: the port's microbench at tools/pallas_microbench.py's
    shapes (it checks gather_rows against index_select, exact); its
    gather_rows row becomes that kernel's row at the microbench shape."""
    bench = {row["op"]: row for row in microbench.run(dev)}
    row = bench["gather_rows_cuda_w128_f32"]
    n, h, u, s = microbench.N, microbench.H, microbench.U, microbench.S
    return [{"name": f"gather_rows (microbench, {u} x {s} ids over "
                     f"[{n}, {h}] f32)",
             "route": "cuda", "source": GATHER_SOURCE,
             "replaces": REPLACES["gather_rows"], "launches": launches,
             **{key: row[key] for key in (
                 "max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
                 "bound_ms", "bound_by", "library_ms",
                 "library_device_ms")}}]


# ------------------------------------------------------------ CLI round trip

def cli_cached(dev: torch.device) -> None:
    """The CLI's cached pipeline on the card: every layer-1 gather through
    gather_rows, every refresh through gather_mean."""
    argv = ["--dataSet", "powerlaw:2000:10000", "--pipeline", "cached",
            "--table_cap", "8", "--learn_method", "plus_unsup", "--epochs",
            "2", "--device", str(dev), "--quiet", "--checkpoint_dir",
            os.path.join(BUILD_DIR, "chip_smoke_ck", "cli_cached")]
    agg.reset_launches()
    t0 = time.perf_counter()
    trainer, _ = cli.run(argv)
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[cli] graphsage_torch.cli {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; best val "
        f"F1 {trainer.max_vali_f1:.6f}")
    assert isinstance(trainer, CachedTrainer)
    assert np.isfinite(trainer.step_losses).all()
    assert (launches["gather_rows"] > 0 and launches["gather_mean"] > 0
            and launches["pair_scores"] > 0), launches


def cli_round_trip(dev: torch.device) -> None:
    out = os.path.join(BUILD_DIR, "chip_smoke_bundles", "cli_plus_unsup")
    argv = ["--dataSet", "powerlaw:2000:10000", "--learn_method",
            "plus_unsup", "--epochs", "1", "--export", out, "--device",
            str(dev), "--quiet", "--checkpoint_dir",
            os.path.join(BUILD_DIR, "chip_smoke_ck", "cli_plus_unsup")]
    agg.reset_launches()
    t0 = time.perf_counter()
    trainer, best = cli.run(argv)
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[cli] graphsage_torch.cli {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; best val "
        f"F1 {trainer.max_vali_f1:.6f}")
    assert launches["gather_mean"] > 0 and launches["pair_scores"] > 0
    params, mcfg, _, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val", meta
    flat_want = flatten_params(best["params"])
    flat_got = flatten_params(params)
    assert flat_want.keys() == flat_got.keys()
    for key in flat_want:
        np.testing.assert_array_equal(flat_got[key], flat_want[key])

    ds = trainer.ds
    pad = ds.graph.to_padded()
    agg.reset_launches()
    sess = infer.InferenceSession.from_bundle(out, ds.features, pad,
                                              device=dev)
    table = sess.embeddings()
    pred = sess.predict(ds.val_nodes)
    launches = dict(agg.LAUNCHES)
    assert launches["gather_mean"] == 2, launches
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       ds.features, pad, device=dev)
    err = check_close("[cli] served table vs full_graph_embeddings",
                      torch.from_numpy(table), torch.from_numpy(want))
    f1 = micro_f1(ds.labels[ds.val_nodes], pred)
    log(f"[cli] bundle params equal the best-val snapshot (epoch "
        f"{best['epoch']}); served table vs full_graph_embeddings max abs "
        f"error {err}; serving launches {launches}; served val micro-F1 "
        f"{f1:.6f}")


# ------------------------------------------------------------ resume

# phase 10 (k): the headline bf16 cached configuration through the CLI
RESUME_K = ["--dataSet", f"powerlaw:{NODES}:{EDGES}", "--pipeline", "cached",
            "--table_cap", "32", "--no_extend", "--b_sz", "32768",
            "--compute_dtype", "bfloat16", "--learn_method", "sup",
            "--epochs", "3", "--name", "k", "--quiet"]
# (l): float32 compact sup on a small graph
RESUME_L = ["--dataSet", "powerlaw:2000:10000", "--learn_method", "sup",
            "--epochs", "3", "--name", "l", "--quiet"]
HOCON = "setting {\n  num_layers = 2\n  hidden_emb_size = 128\n}\n"
# (m): device time queued ahead of the guarded fetch, and its deadline
SLEEP_S, DEADLINE_S = 5.0, 1.0
# (m) in a real compact step through the CLI: device time queued inside
# step STEP_WEDGE_AT, far longer than the deadline.  A kernel's first
# launch waits for the kernels running (CUDA loads it then), so the step
# comes late enough that its kernels (cuBLAS's picks for its bucketed
# shapes among them) have been launched before
STEP_SLEEP_S, STEP_DEADLINE_S, STEP_WEDGE_AT = 30.0, 2.0, 20
STEP_WEDGE_ARGS = ["--dataSet", f"powerlaw:{NODES}:{EDGES}", "--learn_method",
                   "sup", "--epochs", "1", "--name", "m", "--quiet"]


def run_dirs(root: str, tag: str) -> tuple[dict, list]:
    """A fresh checkpoint dir, metrics file and bundle dir under root/tag,
    and the CLI flags that name them."""
    base = os.path.join(root, tag)
    paths = {"ck": os.path.join(base, "ck"),
             "metrics": os.path.join(base, "metrics.jsonl"),
             "bundle": os.path.join(base, "bundle")}
    os.makedirs(base)
    return paths, ["--checkpoint_dir", paths["ck"], "--metrics",
                   paths["metrics"], "--export", paths["bundle"]]


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def unbroken_run(argv: list, root: str, tag: str, dev: torch.device):
    """The CLI in this process, its launches counted and its checkpoint
    writes timed."""
    from graphsage_torch.utils import checkpoint
    paths, flags = run_dirs(root, tag)
    writes = []
    save = checkpoint.save_checkpoint

    def timed_save(path, *args, **kw):
        t0 = time.perf_counter()
        save(path, *args, **kw)
        writes.append(((time.perf_counter() - t0) * 1e3,
                       os.path.getsize(path)))

    agg.reset_launches()
    t0 = time.perf_counter()
    with patched(checkpoint, save_checkpoint=timed_save):
        trainer, _ = cli.run(argv + flags + ["--device", str(dev)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[resume {tag}] graphsage_torch.cli in this process: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; "
        f"checkpoint writes (ms, bytes) {writes}")
    return paths, launches, writes, trainer


def supervised_run(argv: list, root: str, tag: str, dev: torch.device,
                   timeout_s: float = 600.0):
    """python -m graphsage_torch.supervise with an injected wedge at epoch 1;
    the supervisor's event lines stamped with this process's clock as they
    arrive.  Returns the paths and the stamped events."""
    paths, flags = run_dirs(root, tag)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["GS_TEST_WEDGE_SENTINEL"] = os.path.join(root, tag, "wedge")
    cmd = [sys.executable, "-u", "-m", "graphsage_torch.supervise",
           "--max_restarts", "2", "--log",
           os.path.join(root, tag, "events.jsonl"), "--", *argv, *flags,
           "--device", str(dev)]
    events, other = [], []
    t0 = time.perf_counter()
    with open(os.path.join(root, tag, "stdout.txt"), "w") as out:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=out,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        killer = threading.Timer(timeout_s, os.killpg,
                                 (proc.pid, signal.SIGKILL))
        killer.start()
        try:
            for line in proc.stderr:
                if line.startswith("[supervisor] "):
                    rec = json.loads(line[len("[supervisor] "):])
                    rec["wall"] = time.time()
                    events.append(rec)
                else:
                    other.append(line.rstrip())
            rc = proc.wait()
        finally:
            killer.cancel()
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[resume {tag}] supervisor rc {rc}; "
                             f"stderr tail {other[-20:]}")
    log(f"[resume {tag}] python -m graphsage_torch.supervise: "
        f"{seconds:.3f} s; events "
        f"{[(e['event'], e.get('rc', e.get('resume'))) for e in events]}")
    kinds = [e["event"] for e in events]
    assert kinds == ["launch", "exit", "restart", "launch", "exit"], kinds
    assert events[1]["rc"] == 17 and events[4]["rc"] == 0, events
    name = os.path.basename(events[2]["resume"] or "")
    assert name.startswith(f"model_best_{argv[argv.index('--name') + 1]}"
                           "_ep0_"), events[2]
    return paths, events


def epoch_records(path: str) -> dict:
    """{epoch: (mean_loss, val_f1)} of a metrics file."""
    recs = read_jsonl(path)
    loss = {r["epoch"]: r["mean_loss"] for r in recs if r["event"] == "epoch"}
    f1 = {r["epoch"]: r["val_f1"] for r in recs if r["event"] == "eval"}
    return {e: (loss[e], f1.get(e)) for e in loss}


def bundle_params(path: str) -> dict:
    params, _, _, meta = infer.load_bundle(path)
    return flatten_params(params), meta


def recovery(paths: dict, events: list) -> dict:
    """Time to recover, from the first child's rc 17 to the end of the
    relaunched child's first epoch, and its parts."""
    recs = read_jsonl(paths["metrics"])
    i = next(i for i, r in enumerate(recs) if r["event"] == "resume")
    res, after = recs[i], recs[i + 1:]
    base = res["wall"] - res["t"]    # this child's logger clock
    first, second = [r for r in after if r["event"] == "epoch"][:2]
    # the second epoch starts after the first one's evaluation records
    second_start = max(r["t"] for r in after
                       if r.get("epoch") == first["epoch"])
    t17, relaunch = events[1]["wall"], events[3]["wall"]
    epoch_end = base + first["t"]
    parts = {"relaunch_s": relaunch - t17,
             "process_start_s": res["ready_wall"] - relaunch,
             "data_s": res["data_s"], "setup_s": res["setup_s"],
             "restore_s": res["restore_s"],
             "first_epoch_s": epoch_end - res["wall"],
             "second_epoch_s": second["t"] - second_start}
    parts["kernel_load_and_warmup_s"] = (parts["first_epoch_s"]
                                         - parts["second_epoch_s"])
    parts["total_s"] = epoch_end - t17
    return parts


def final_state(trainer) -> dict:
    """A trainer's final params (flattened, on the host) and its last
    epoch's step losses."""
    return {"params": flatten_params(params_to_numpy(trainer.params)),
            "losses": list(trainer.step_losses)}


def resumed_run(argv: list, root: str, tag: str, events: list,
                dev: torch.device) -> dict:
    """The CLI in this process resumed from the checkpoint that the
    supervisor's relaunch resumed from; its final state."""
    _, flags = run_dirs(root, tag)
    trainer, _ = cli.run(argv + flags + ["--resume", events[2]["resume"],
                                         "--device", str(dev)])
    return final_state(trainer)


def resume_equal(tag: str, unbroken: dict, supervised: dict, final: dict,
                 resumed: dict) -> None:
    """Epochs 1-2's losses and val F1s and the exported params of the
    supervised run, and the last epoch's step losses and the final params
    of the resumed one, equal the unbroken run's bit for bit."""
    a, b = epoch_records(unbroken["metrics"]), epoch_records(
        supervised["metrics"])
    for e in (1, 2):
        assert a[e] == b[e], (tag, e, a[e], b[e])
    pa, meta_a = bundle_params(unbroken["bundle"])
    pb, meta_b = bundle_params(supervised["bundle"])
    assert pa.keys() == pb.keys()
    for key in pa:
        np.testing.assert_array_equal(pb[key], pa[key], err_msg=key)
    assert meta_a == meta_b, (meta_a, meta_b)
    assert resumed["losses"] == final["losses"], (resumed, final)
    assert resumed["params"].keys() == final["params"].keys()
    for key in final["params"]:
        np.testing.assert_array_equal(resumed["params"][key],
                                      final["params"][key], err_msg=key)
    log(f"[resume {tag}] epochs 1-2 (mean_loss, val_f1) equal: {a[1]}, "
        f"{a[2]}; exported params equal bit for bit (best-val epoch "
        f"{meta_a['epoch']}); resumed in this process: final params and "
        f"the last epoch's {len(final['losses'])} step losses equal bit "
        f"for bit")


def resume_close(tag: str, unbroken: dict, supervised: dict, final: dict,
                 resumed: dict, loss_rtol: float, param_atol: float) -> dict:
    """Epochs 1-2's mean losses and the last epoch's step losses within
    loss_rtol, the exported and the final params within param_atol;
    returns the largest differences."""
    a, b = epoch_records(unbroken["metrics"]), epoch_records(
        supervised["metrics"])
    pa, meta_a = bundle_params(unbroken["bundle"])
    pb, meta_b = bundle_params(supervised["bundle"])
    assert pa.keys() == pb.keys()
    assert resumed["params"].keys() == final["params"].keys()
    assert len(resumed["losses"]) == len(final["losses"])
    diffs = {"loss_rel": max(abs(b[e][0] - a[e][0]) / abs(a[e][0])
                             for e in (1, 2)),
             "step_loss_rel": max(abs(r - f) / abs(f) for r, f in zip(
                 resumed["losses"], final["losses"])),
             "final_param_abs": max(
                 float(np.abs(resumed["params"][k] - final["params"][k])
                       .max()) for k in final["params"]),
             "bundle_param_abs": max(float(np.abs(pb[k] - pa[k]).max())
                                     for k in pa),
             "val_f1_equal": all(a[e][1] == b[e][1] for e in (1, 2)),
             "best_epoch": (meta_a["epoch"], meta_b["epoch"]),
             "steps": len(final["losses"])}
    log(f"[resume {tag}] against the unbroken run: {diffs} (loss rtol "
        f"{loss_rtol}, params atol {param_atol})")
    assert (diffs["loss_rel"] <= loss_rtol
            and diffs["step_loss_rel"] <= loss_rtol
            and diffs["final_param_abs"] <= param_atol
            and diffs["bundle_param_abs"] <= param_atol), diffs
    return diffs


DEADLINE_CHILD = r"""
import json, sys, time
import torch
from graphsage_torch import cli
from graphsage_torch.utils.obs import FetchDeadlineError, fetch_with_deadline

class Wedged:
    def fit(self):
        # load the sleep and add kernels first: CUDA loads a kernel at its
        # first launch, and that load waits for the kernels running
        x = torch.ones((), device="cuda")
        torch.cuda._sleep(1000)
        fetch_with_deadline(x + 1, timeout_s=60.0)
        torch.cuda._sleep(int(sys.argv[1]))
        y = x + 1
        t0 = time.perf_counter()
        try:
            fetch_with_deadline(y, label="a sleeping kernel's output",
                                timeout_s=float(sys.argv[2]))
        except FetchDeadlineError:
            print(json.dumps({"raised_after_s": time.perf_counter() - t0}),
                  flush=True)
            raise
        raise AssertionError("the fetch returned before its deadline")

cli.fit_or_exit(Wedged())
"""


def deadline_check() -> dict:
    """(m): a fetch behind SLEEP_S of queued device time raises
    FetchDeadlineError after DEADLINE_S, and the CLI's exit path ends the
    process with code 17 soon after."""
    cycles = 10**8
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: torch.cuda._sleep(cycles), 3)
    cycles = int(cycles * SLEEP_S * 1e3 / ms)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", DEADLINE_CHILD, str(cycles),
         str(DEADLINE_S)], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        line = proc.stdout.readline()
        raised_wall = time.perf_counter()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    exit_s = time.perf_counter() - raised_wall
    err = proc.stderr.read()
    res = {"sleep_cycles": cycles, "sleep_ms_per_1e8_cycles": ms,
           "raised_after_s": json.loads(line)["raised_after_s"]
           if line.startswith("{") else None,
           "rc": rc, "exit_after_raise_s": exit_s,
           "process_s": time.perf_counter() - t0}
    log(f"[resume m] {json.dumps(res)}; child stderr: "
        f"{err.strip().splitlines()[:4]}")
    assert res["raised_after_s"] is not None, (line, err)
    assert DEADLINE_S <= res["raised_after_s"] <= 3 * DEADLINE_S, res
    assert rc == cli.WEDGE_EXIT and exit_s <= 10.0, res
    return res


STEP_WEDGE_CHILD = r"""
import json, sys, time
import torch
from graphsage_torch import cli
from graphsage_torch.train import trainer as trainer_mod

cycles, at = int(sys.argv[1]), int(sys.argv[2])
encode = trainer_mod.graphsage_apply_gathered
update = trainer_mod.apply_gradients
calls = {"encode": 0, "update": 0}

def encode_then_sleep(*args, **kw):
    out = encode(*args, **kw)
    calls["encode"] += 1
    if calls["encode"] == at:
        # a kernel that runs far past the deadline, inside the step
        torch.cuda._sleep(cycles)
        print(json.dumps({"slept_at": time.time()}), flush=True)
    return out

def update_then_report(*args, **kw):
    update(*args, **kw)
    calls["update"] += 1
    if calls["update"] == at:
        # the step's launches after the sleep did not wait for it
        print(json.dumps({"updated_at": time.time()}), flush=True)

torch.cuda._sleep(1000)     # load the sleep kernel while nothing runs
trainer_mod.graphsage_apply_gathered = encode_then_sleep
trainer_mod.apply_gradients = update_then_report
cli.main(sys.argv[3:])
"""


def step_wedge_check(ms_per_1e8_cycles: float, root: str,
                     dev: torch.device) -> dict:
    """(m) in a real step: the CLI's compact Trainer at full width, with
    device sleep queued inside step STEP_WEDGE_AT, must end with code 17
    within 3 deadlines of the sleep, having named that step's loss fetch."""
    cycles = int(1e8 * STEP_SLEEP_S * 1e3 / ms_per_1e8_cycles)
    _, flags = run_dirs(root, "m_step")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["GS_FETCH_TIMEOUT_S"] = str(STEP_DEADLINE_S)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", STEP_WEDGE_CHILD, str(cycles),
         str(STEP_WEDGE_AT), *STEP_WEDGE_ARGS, *flags, "--device", str(dev)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=STEP_SLEEP_S + 120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    ended = time.time()
    marks = {k: v for line in out.splitlines() if line.startswith('{"')
             for k, v in json.loads(line).items()}
    fatal = [line for line in out.splitlines() if line.startswith("FATAL")]
    slept = marks.get("slept_at")
    res = {"rc": proc.returncode, "sleep_cycles": cycles,
           "step_done_after_sleep_s": marks["updated_at"] - slept
           if "updated_at" in marks and slept else None,
           "exit_after_sleep_s": ended - slept if slept else None,
           "process_s": time.perf_counter() - t0, "fatal": fatal}
    log(f"[resume m] a real step: {json.dumps(res)}; child stderr: "
        f"{err.strip().splitlines()[:4]}")
    assert slept, (out, err)
    assert res["rc"] == cli.WEDGE_EXIT, (res, err)
    assert res["exit_after_sleep_s"] <= 3 * STEP_DEADLINE_S, res
    assert fatal and f"step {STEP_WEDGE_AT} loss fetch" in fatal[0], res
    return res


def resume_phase(dev: torch.device) -> None:
    """Phase 10: checkpoints, --config, --resume and the supervisor's
    wedge-and-relaunch loop at full width, and the fetch deadline on real
    device work."""
    import shutil
    root = os.path.join(BUILD_DIR, "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf = os.path.join(root, "k.conf")
    with open(conf, "w") as f:
        f.write(HOCON)
    t0 = time.perf_counter()

    # (k) the headline bf16 cached configuration
    argv = RESUME_K + ["--config", conf]
    unbroken, launches, writes, trainer = unbroken_run(argv, root, "k",
                                                       dev)
    assert trainer.mcfg.num_layers == 2 and trainer.mcfg.out_size == 128
    for name in ("gather_rows", "gather_mean", "scatter_rows"):
        assert launches[name] > 0, launches
    final = final_state(trainer)
    del trainer
    if dev.type == "cuda":
        # the children need the card's memory that this process caches
        torch.cuda.empty_cache()
    supervised, events = supervised_run(argv, root, "k_supervised", dev)
    parts = recovery(supervised, events)
    log(f"[resume k] time to recover (s): {json.dumps(parts)}")
    log(f"[resume k] checkpoint write ms {[w[0] for w in writes]}, bytes "
        f"{[w[1] for w in writes]}")
    # every gradient scatter on this path is scatter_rows, deterministic
    # by design, so the resumed run must equal the unbroken one exactly
    resumed = resumed_run(argv, root, "k_resumed", events, dev)
    resume_equal("k", unbroken, supervised, final, resumed)
    # (l) float32 compact sup: index_add_'s atomics add in varying order
    unbroken_l, _, _, trainer = unbroken_run(RESUME_L, root, "l", dev)
    final = final_state(trainer)
    del trainer
    supervised_l, events = supervised_run(RESUME_L, root, "l_supervised",
                                          dev)
    resumed = resumed_run(RESUME_L, root, "l_resumed", events, dev)
    resume_close("l", unbroken_l, supervised_l, final, resumed, LOSS_RTOL,
                 PARAM_ATOL)
    if dev.type == "cuda":
        res = deadline_check()
        step_wedge_check(res["sleep_ms_per_1e8_cycles"], root, dev)
    log(f"[resume] phase 10 took {time.perf_counter() - t0:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # uniform negatives: "auto" would choose by the host's core count
    os.environ["GS_EXACT_NEG_BUDGET_S"] = "0"
    return run(torch.device("cuda"))


def run(dev: torch.device) -> int:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    start = time.perf_counter()

    def phase_done(what: str) -> None:
        log(f"-- {what} done at {time.perf_counter() - start:.1f} s")

    t0 = time.perf_counter()
    reused = all(build.library_path(name).exists() for name in build.SOURCES)
    # the host engine (g++) builds beside the kernels (one nvcc each)
    engine = concurrent.futures.ThreadPoolExecutor(1).submit(
        native_build.build)
    paths = build.build()
    for name in build.SOURCES:
        build.load_library(name)
    log(f"build: {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.3f} s"
        f"{' (existing builds, reused)' if reused else ''}")
    for path in paths.values():
        log(path.with_suffix(".log").read_text().strip())
    log(f"build: host engine {engine.result().name} ready after "
        f"{time.perf_counter() - t0:.3f} s")
    smi = nvidia_smi()
    log(f"card: {smi}")
    global ADD_NS
    ADD_NS = add_latency(dev)

    small_graph_check(dev)
    phase_done("phases 1-2 (build, small graph)")

    t0 = time.perf_counter()
    ds = synthetic_power_law(NODES, EDGES, num_feats=FEATS,
                             num_classes=CLASSES, seed=0)
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    n_valid = int(pad.degrees.sum())
    log(f"graph: {NODES} nodes, {ds.graph.num_edges} directed edges, "
        f"table [{pad.num_nodes}, {pad.width}], {n_valid} valid slots, "
        f"made in {time.perf_counter() - t0:.3f} s")
    feats = torch.from_numpy(ds.features).to(dev)
    pad = PaddedAdjacency(neighbors=torch.from_numpy(pad.neighbors).to(dev),
                          degrees=torch.from_numpy(pad.degrees).to(dev),
                          true_degrees=pad.true_degrees,
                          truncated=pad.truncated)

    summaries, rows = [], []
    for agg_func, dtype in CONFIGS:
        cfg = GraphSageConfig(num_layers=2, input_size=FEATS,
                              out_size=HIDDEN, agg_func=agg_func,
                              compute_dtype=dtype)
        gen = torch.Generator().manual_seed(824)
        params = {"sage": init_graphsage(gen, cfg),
                  "clf": init_classifier(gen, HIDDEN, CLASSES)}
        summary, kernel_rows = serve_config(f"{agg_func} {dtype}", cfg,
                                            params, feats, pad, n_valid, dev)
        summaries.append(summary)
        rows.extend(kernel_rows)
    log(json.dumps({"serving": summaries}))
    phase_done("phase 3 (serving)")

    train_ds = dataclasses.replace(ds,
                                   train_nodes=ds.train_nodes[:TRAIN_NODES])
    training = {method: train_method(method, train_ds, dev)
                for method in ("plus_unsup", "sup")}
    unsup = training["plus_unsup"]
    step_inputs = capture_step_inputs(unsup["trainer"])
    rows.extend(mean_step_rows(step_inputs,
                               unsup["launches"]["gather_mean"]))
    rows.extend(score_rows(step_inputs, unsup["launches"]["pair_scores"],
                           dev))
    # MAX (sup, gcn) and LSTM (plus_unsup) on the compact pipeline
    for key, method, agg_func, gcn in (("sup MAX gcn", "sup", "MAX", True),
                                       ("plus_unsup LSTM", "plus_unsup",
                                        "LSTM", False)):
        res = training[key] = train_method(method, train_ds, dev, agg_func,
                                           gcn, free_running=False)
        step_inputs = capture_step_inputs(res["trainer"])
        step_rows = max_step_rows if agg_func == "MAX" else lstm_step_rows
        rows.extend(step_rows(step_inputs, res["launches"]))
    log(json.dumps({"training": {
        method: {"ms_per_step": v["ms_per_step"]}
        for method, v in training.items()}}))
    del training, unsup, step_inputs, res
    phase_done("phases 4-5 (compact training, kernel rows)")

    cli_round_trip(dev)
    cli_cached(dev)
    phase_done("phase 6 (CLI)")

    results = {}
    for config in CACHED_CONFIGS:
        results[config[0]] = cached_config(*config, ds=ds, dev=dev)
    rows.extend(cached_rows(results))
    log(json.dumps({"cached": {label: res["summary"]
                               for label, res in results.items()}}))
    total = sum(res["launches"]["gather_rows"] for res in results.values())
    phase_done("phase 7 (cached training)")

    # phase 3 for the cached-LSTM hybrid that (d) trained and exported
    params, cfg, _, meta = infer.load_bundle(results["d"]["bundle"])
    assert meta["lstm_hybrid"] is True
    summary, _ = serve_config("LSTM hybrid float32", cfg, params, feats, pad,
                              n_valid, dev, lstm_hybrid=True)
    log(json.dumps({"serving": [summary]}))
    del results, feats, pad
    phase_done("phase 3 for the hybrid")
    rows.extend(microbench_rows(dev, total))
    phase_done("phase 8 (microbench)")

    rows.extend(bf16_phase(ds, train_ds, dev, phase_done))
    phase_done("phase 9 (bf16 training)")

    del ds, train_ds
    resume_phase(dev)
    phase_done("phase 10 (checkpoints and resume)")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
