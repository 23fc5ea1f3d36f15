"""Drive graphsage_torch's serving path on one NVIDIA card and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build the kernels from graphsage_torch/csrc with nvcc (build seconds and
   nvcc's register report printed).
2. A small graph through the kernels against a float64 numpy oracle of the
   reference semantics (MEAN/MAX x gcn).
3. Serving at full width: the 100,000-node, 1,000,000-edge power-law graph
   with 602 features, a width-32 sampled adjacency, a 2-layer GraphSAGE with
   hidden 128, weights from a seeded torch.Generator; for MEAN float32, MEAN
   bfloat16 and MAX bfloat16:
   - launch counts set to 0, then the main path a user calls:
     InferenceSession.embeddings(), predict/log_probs on three node
     batches, score_pairs, and an export_bundle -> from_bundle round trip
     that must give identical embeddings and predictions; counts read;
   - embed-all time (host clock around a synchronised call, warm; median,
     min and max of 20), and the device's busy time by kernel over one
     embed-all (torch.profiler);
   - the full embedding table against the same session run through the
     plain versions on the card;
   - each kernel alone at that layer's shapes against its plain version,
     timed with CUDA events over many warm launches, beside its byte bound,
     the plain version's time and a one-call library yardstick.

Tolerances: float32 rtol=atol=1e-5; bfloat16 within 2 bf16 ulps of the
reference value (the two versions may sum in different orders); MAX exact.

The last lines are a JSON object of per-kernel results, the card's name and
power limit from nvidia-smi, and the result line
{"ok": true, "device": {...}}.  Matrix products run in full float32
(TF32 off).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from graphsage_torch import infer
from graphsage_torch.data import (CSRGraph, PaddedAdjacency,
                                  synthetic_power_law)
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import build

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
NODES, EDGES, FEATS, CLASSES, WIDTH, HIDDEN = (100_000, 1_000_000, 602, 16,
                                               32, 128)
CONFIGS = (("MEAN", "float32"), ("MEAN", "bfloat16"), ("MAX", "bfloat16"))
SOURCE = "graphsage_torch/csrc/aggregate.cu"
REPLACES = {"gather_mean": "graphsage_tpu/ops/pallas_aggregate.py:60",
            "gather_max": "graphsage_tpu/ops/pallas_aggregate.py:76"}


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
                exact: bool = False) -> float:
    """Max abs error of got vs want; raises outside the stated tolerance."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        ok = bool(torch.equal(got, want))
    elif want.dtype == torch.bfloat16:
        ok = bool((diff <= 2 * bf16_ulp(want)).all())
    else:
        ok = bool((diff <= 1e-5 + 1e-5 * want.float().abs()).all())
    if not ok:
        raise AssertionError(f"{name}: max abs error {err} outside "
                             f"tolerance")
    return err


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over reps back-to-back calls (warm)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_aggregates():
    """Serving through the plain versions on the card (the reference run)."""
    saved = infer.mean_aggregate, infer.max_aggregate
    infer.mean_aggregate = agg.mean_aggregate_plain
    infer.max_aggregate = agg.max_aggregate_plain
    try:
        yield
    finally:
        infer.mean_aggregate, infer.max_aggregate = saved


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
        "ms": cuda_ms(lambda: kernel(embed, idx, mask), reps=50),
        "plain_ms": cuda_ms(lambda: plain(embed, idx, mask), reps=5),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": cuda_ms(library, reps=20),
    }
    log(f"kernel {row['name']}: embed {tuple(embed.shape)} stride "
        f"{embed.stride(0)} {embed.dtype}, idx {tuple(idx.shape)}, "
        f"{n_valid} valid slots, {rows_read} rows read, {nbytes} bytes; "
        f"ms {row['ms']:.6f} bound_ms {row['bound_ms']:.6f} plain_ms "
        f"{row['plain_ms']:.6f} library_ms {row['library_ms']:.6f} "
        f"[{library_note}, max abs diff to the kernel {library_err}] "
        f"max_abs_err {err}")
    return row


# ------------------------------------------------------------ serving

def profile_embed_all(fn, wall_ms: float) -> None:
    """Device kernel time by kernel over one embed-all (torch.profiler), and
    the device's idle share against the warm embed-all time."""
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
    log(f"  profile: device busy {busy:.6f} ms of embed_all_ms "
        f"{wall_ms:.6f} (idle share {1 - busy / wall_ms:.4f}); by kernel:")
    for t, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {t / 1e3:10.6f} ms  x{count:<3d} {key[:100]}")


def serve_config(agg_func: str, dtype: str, feats: torch.Tensor,
                 pad, n_valid: int, dev: torch.device) -> tuple[dict, list]:
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=agg_func, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(824)
    params = {"sage": init_graphsage(gen, cfg),
              "clf": init_classifier(gen, HIDDEN, CLASSES)}
    kname = "gather_mean" if agg_func == "MEAN" else "gather_max"
    tag = f"{agg_func} {dtype}"
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, NODES, size) for size in (1, 64, 4096)]

    # -------- the main path, counted
    agg.reset_launches()
    t0 = time.perf_counter()
    sess = infer.InferenceSession(params, cfg, feats, pad, device=dev)
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
    infer.export_bundle(bundle, params, cfg, CLASSES)
    again = infer.InferenceSession.from_bundle(bundle, feats, pad,
                                               device=dev)
    np.testing.assert_array_equal(again.embeddings(), emb)
    for nodes, want in zip(batches, preds):
        np.testing.assert_array_equal(again.predict(nodes), want)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    log(f"[{tag}] main path: 2 sessions, 3 batches, score_pairs, bundle "
        f"round trip in {serve_s:.3f} s; launches {launches}")
    assert emb.shape == (NODES, HIDDEN) and np.isfinite(emb).all()
    assert np.abs(emb).sum() > 0
    # two layers per embeddings() call, two sessions
    assert launches[kname] == 4, launches
    assert sum(launches.values()) == 4, launches

    # -------- embed-all time (warm, device-resident inputs)
    def embed_all():
        return infer.full_graph_embeddings(sess.params["sage"], cfg,
                                           sess.feats, sess.pad, fetch=False,
                                           device=dev)

    embed_all()
    times = []
    for _ in range(20):
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
    profile_embed_all(embed_all, ms)

    # -------- whole table against the plain versions on the card
    table = embed_all()
    with plain_aggregates():
        ref = embed_all()
    err = check_close(f"[{tag}] embedding table vs plain", table, ref)
    log(f"[{tag}] embedding table vs plain versions on the card: max abs "
        f"error {err}")

    # -------- each kernel alone at its layer's shapes
    idx, mask = infer._slot_table(sess.pad.neighbors, sess.pad.degrees,
                                  cfg.gcn)
    h0 = sess.feats.to(getattr(torch, dtype))
    rows = []
    with torch.no_grad():
        if agg_func == "MEAN":
            from graphsage_torch.models.layers import mean_pretransform
            z = mean_pretransform(sess.params["sage"]["layers"][0]["weight"],
                                  h0)
            rows.append(kernel_row(kname, f"{dtype}, both layers",
                                   z[:, HIDDEN:], idx, mask, launches[kname]))
        else:
            h1 = infer._layer_full(cfg, sess.params["sage"], 0, h0, idx,
                                   mask, NODES)
            rows.append(kernel_row(kname, f"{dtype}, layer 1", h0, idx, mask,
                                   launches[kname]))
            rows.append(kernel_row(kname, f"{dtype}, layer 2", h1, idx, mask,
                                   launches[kname]))
    return {"config": tag, "embed_all_ms": ms}, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch.device("cuda"))


def run(dev: torch.device) -> int:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    reused = build.library_path().exists()
    lib_path = build.build()
    build.load_library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.3f} s"
        f"{' (an existing build, reused)' if reused else ''}")
    log(lib_path.with_suffix(".log").read_text().strip())
    smi = nvidia_smi()
    log(f"card: {smi}")

    small_graph_check(dev)

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
        summary, kernel_rows = serve_config(agg_func, dtype, feats, pad,
                                            n_valid, dev)
        summaries.append(summary)
        rows.extend(kernel_rows)

    log(json.dumps({"serving": summaries}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
