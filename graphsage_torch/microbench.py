"""Microbenchmarks of the port's kernels on the card.

Port of ``tools/pallas_microbench.py``, at its shapes, with each CUDA
kernel beside its plain PyTorch version and, where there is one, the one
PyTorch call that computes the same function:

1. row gather: ``gather_rows`` vs ``index_select``, 45,056 x 11 ids over
   a [100000, 128] float32 table, and 5,632 ids over a [100000, 602]
   float32 table (the cached pipeline's per-occurrence width); the two must
   be equal bit for bit;
2. gather+mean: ``gather_mean`` [45056, 11] over the [100000, 128] table,
   and at the leaf-cache refresh's shape, [100000, 10] over the [100000,
   602] table, vs its plain version and ``F.embedding_bag``;
3. scatter-add (the backward of a gather): ``index_add_`` of 495,616 rows
   into [100000, 128], unsorted and presorted (the sort not counted);
4. pair scores: the [512 x 2048] block, H 128, ``pair_scores`` vs its
   plain version.

Each kernel row carries three times: ``ms``, CUDA events over back-to-back
warm calls of the wrapper (the slower of the device and the host's
dispatch); ``device_ms``, the kernel's own device time per launch
(:func:`device_ms`); ``host_us``, the wrapper's host time per call
(:func:`host_us`).  The library call gets ``library_ms`` and
``library_device_ms`` alike.  Each row carries the least time the card
could take (``bound_ms``: bytes over 3.35 TB/s or operations over 67
TFLOP/s float32, the larger), and the card's name.
Needs a card; prints one JSON row per measurement and writes the list to
a file only when given ``--out``.

    python -m graphsage_torch.microbench [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import gather, sddmm

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bfloat16 tensor cores, dense
L2_BYTES = 50 * 2**20            # H100 SXM L2 cache
# the kernel of l2_evictor's write, which the cold device times leave out
EVICT_KERNEL = "bitwise_not"
N, H = 100_000, 128
U, S = 45056, 11
FEATS, FANOUT, PER_OCCURRENCE = 602, 10, 5632


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


def l2_evictor():
    """A callable that evicts the card's L2 cache: one kernel rewriting a
    buffer of twice the L2's size (an in-place ``bitwise_not``)."""
    buf = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device="cuda")
    return buf.bitwise_not_


def cold_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of one fn() on a cold L2: each call comes right
    after an eviction (:func:`l2_evictor`) and has its own pair of CUDA
    events, so the eviction is not timed."""
    evict = l2_evictor()
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        evict()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def device_ms(fn, kernel: str | None = None, reps: int = 20,
              cold: bool = False, tries: int = 3) -> float:
    """Device time per call of fn() (warm), from torch.profiler over reps
    calls: for each kernel whose name holds ``kernel`` (every kernel when
    None), its self device time per recorded launch times its launches a
    call.  Per recorded launch, because the profiler can drop records on
    the card.  With ``cold`` each call comes right after an L2 eviction
    (:func:`l2_evictor`), whose kernel (``EVICT_KERNEL``) is left out.
    The profiler can also drop every record of a run; after ``tries`` such
    runs the time is taken with CUDA events instead, and a line on
    standard error says so: with ``cold`` around each call
    (:func:`cold_ms`), else around a CUDA graph of reps calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    evict = l2_evictor() if cold else None
    profiled = (lambda: (evict(), fn())) if cold else fn
    profiled()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                profiled()
            torch.cuda.synchronize()
        recorded = [(evt.self_device_time_total, evt.count)
                    for evt in prof.key_averages()
                    if evt.device_type == DeviceType.CUDA
                    and evt.self_device_time_total
                    and (kernel is None or kernel in evt.key)
                    and not (cold and EVICT_KERNEL in evt.key)]
        if recorded:
            return sum(t / n * max(1, round(n / reps))
                       for t, n in recorded) / 1e3
    print(f"device_ms: the profiler recorded no device time of "
          f"{kernel or 'any kernel'} in {tries} runs; timed with CUDA "
          f"events instead", file=sys.stderr, flush=True)
    if cold:
        return cold_ms(fn, reps=reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 20, rounds: int = 5) -> float:
    """Host time per call of fn() in microseconds: the host clock around
    reps back-to-back calls (warm), before the device has caught up; the
    least of ``rounds`` such runs, since the card's host is shared and other
    work only adds to a run."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / reps * 1e6


def times(fn, kernel: str | None, library=None, reps: int = 50,
          cold: bool = False) -> dict:
    """ms, device_ms and host_us of fn (kernel: its kernel's name), and
    library_ms and library_device_ms of the library call, if any.  With
    ``cold`` each timed call runs on a cold L2, as on a path that rewrites
    its tables between launches: ``ms`` from :func:`cold_ms`, the device
    times with an eviction before each call and its kernel left out."""
    timer = cold_ms if cold else cuda_ms
    row = {"ms": timer(fn, reps=reps),
           "device_ms": device_ms(fn, kernel, cold=cold),
           "host_us": host_us(fn)}
    if library is not None:
        row["library_ms"] = timer(library, reps=reps)
        row["library_device_ms"] = device_ms(library, cold=cold)
    return row


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def run(dev: torch.device) -> list[dict]:
    """The measurements on ``dev``; returns the rows (also printed)."""
    rows = []
    kind = torch.cuda.get_device_name(dev)

    def record(op, nbytes, ops=0.0, detail="", **extra):
        bound, by = bound_ms(nbytes, ops)
        row = {"op": op, "bound_ms": bound, "bound_by": by, "detail": detail,
               "device": kind, **extra}
        rows.append(row)
        print(json.dumps(row), flush=True)

    rng = np.random.RandomState(0)
    table = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, H), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, N, (U, S)).astype(np.int32)).to(dev)
    mask = torch.from_numpy((rng.rand(U, S) < 0.9).astype(np.float32)).to(dev)
    flat = idx.reshape(-1)
    j = flat.shape[0]

    # the 602-wide rows' inputs (their own generators: the other rows'
    # inputs stay as they were)
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (N, FEATS), dtype=np.float32)).to(dev)
    wide_rng = np.random.RandomState(3)
    occ = torch.from_numpy(wide_rng.randint(0, N, PER_OCCURRENCE).astype(
        np.int32)).to(dev)
    refresh_idx = torch.from_numpy(wide_rng.randint(
        0, N, (N, FANOUT)).astype(np.int32)).to(dev)
    refresh_mask = torch.from_numpy(
        (wide_rng.rand(N, FANOUT) < 0.9).astype(np.float32)).to(dev)

    # 1. row gather: each distinct row read once, each output row written
    for op, tab, ids in (("gather_rows_cuda_w128_f32", table, flat),
                         ("gather_rows_cuda_w602_f32", feats, occ)):
        got = gather.gather_rows_kernel(tab, ids)
        want = gather.gather_rows_plain(tab, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{op}: gather_rows differs from "
                                 f"index_select")
        n_ids, width = ids.shape[0], tab.shape[1]
        rows_read = int(torch.unique(ids).numel())
        t = times(lambda: gather.gather_rows_kernel(tab, ids),
                  "gather_rows_kernel",
                  library=lambda: tab.index_select(0, ids))
        record(op, (rows_read + n_ids) * width * 4 + n_ids * 4,
               detail=f"{n_ids} ids, {rows_read} distinct rows over "
                      f"[{N},{width}]: {n_ids / t['device_ms'] / 1e3:.0f}M "
                      f"rows/s of device time; equal to index_select",
               max_abs_err=0.0,
               plain_ms=cuda_ms(lambda: gather.gather_rows_plain(tab, ids),
                                reps=50), **t)

    # 2. gather+mean, at the microbench's shape and the refresh's
    for op, tab, ids, msk in (
            ("gather_mean_cuda", table, idx, mask),
            ("gather_mean_cuda_refresh_w602_f32", feats, refresh_idx,
             refresh_mask)):
        got = agg.mean_aggregate(tab, ids, msk)
        err = float((got - agg.mean_aggregate_plain(tab, ids, msk)).abs()
                    .max())
        weights = msk / msk.sum(1, keepdim=True).clamp_min(1.0)
        valid = msk > 0
        rows_read = int(torch.unique(ids[valid]).numel())
        (u, s), width = ids.shape, tab.shape[1]
        t = times(lambda: agg.mean_aggregate(tab, ids, msk),
                  "gather_reduce_kernel",
                  library=lambda: F.embedding_bag(
                      ids, tab, mode="sum", per_sample_weights=weights),
                  reps=20)
        record(op, rows_read * width * 4 + 2 * u * s * 4 + u * width * 4,
               ops=2 * int(valid.sum()) * width,
               detail=f"[{u},{s}] over [{N},{width}], {rows_read} distinct "
                      f"rows read; max abs err vs plain {err}",
               max_abs_err=err,
               plain_ms=cuda_ms(lambda: agg.mean_aggregate_plain(tab, ids,
                                                                 msk),
                                reps=5), **t)
    del feats, refresh_idx, refresh_mask

    # 3. scatter-add (the gather's backward)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (U, H), dtype=np.float32)).to(dev)
    contrib = (g[:, None, :] * mask[:, :, None]).reshape(-1, H)
    long_idx = flat.long()
    acc = torch.zeros((N, H), device=dev)     # added into, never reset
    nbytes = j * H * 4 + j * 8 + N * H * 4
    ms = cuda_ms(lambda: acc.index_add_(0, long_idx, contrib), reps=20)
    record("scatter_add_index_add", nbytes, ops=j * H, ms=ms,
           detail=f"{j} rows into [{N},{H}]: {j / ms / 1e3:.0f}M rows/s")
    order = torch.argsort(long_idx)
    idx_s, contrib_s = long_idx[order], contrib[order].contiguous()
    record("scatter_add_index_add_presorted", nbytes, ops=j * H,
           ms=cuda_ms(lambda: acc.index_add_(0, idx_s, contrib_s), reps=20),
           detail="sorted indices (the sort and permute not counted)")

    # 4. pair scores
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2048, H), dtype=np.float32)).to(dev)
    targets = torch.from_numpy(rng.randint(0, 2048, 512).astype(
        np.int32)).to(dev)
    got = sddmm.pair_scores_kernel(emb, targets)
    err = float((got - sddmm.dense_pair_scores(emb, targets)).abs().max())
    t_long = targets.long()
    t = times(lambda: sddmm.pair_scores_kernel(emb, targets),
              "pair_scores_kernel",
              library=lambda: torch.mm(F.normalize(emb[t_long], eps=1e-8),
                                       F.normalize(emb, eps=1e-8).T),
              reps=100)
    record("pair_scores_cuda", 2048 * H * 4 + 512 * 4 + 512 * 2048 * 4,
           ops=2 * 512 * 2048 * H + 3 * (2048 + 512) * H,
           detail=f"[512 x 2048] block; max abs err vs plain {err}",
           max_abs_err=err,
           plain_ms=cuda_ms(lambda: sddmm.dense_pair_scores(emb, targets),
                            reps=50), **t)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the rows as a JSON list to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("graphsage_torch.microbench needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(torch.device("cuda"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
