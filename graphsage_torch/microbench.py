"""Microbenchmarks of the port's kernels on the card.

Port of ``tools/pallas_microbench.py``, at its shapes, with each CUDA
kernel beside its plain PyTorch version and, where there is one, the one
PyTorch call that computes the same function:

1. row gather: ``gather_rows`` vs ``index_select``, 45,056 x 11 ids over
   a [100000, 128] float32 table (the two must be equal bit for bit);
2. gather+mean: ``gather_mean`` [45056, 11] over the same table vs its
   plain version and ``F.embedding_bag``;
3. scatter-add (the backward of a gather): ``index_add_`` of 495,616 rows
   into [100000, 128], unsorted and presorted (the sort not counted);
4. pair scores: the [512 x 2048] block, H 128, ``pair_scores`` vs its
   plain version.

Times are CUDA events over back-to-back warm calls.  Each row carries the
least time the card could take (``bound_ms``: bytes over 3.35 TB/s or
operations over 67 TFLOP/s float32, the larger), and the card's name.
Needs a card; prints one JSON row per measurement and writes the list to
a file only when given ``--out``.

    python -m graphsage_torch.microbench [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import gather, sddmm

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
N, H = 100_000, 128
U, S = 45056, 11


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


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def run(dev: torch.device) -> list[dict]:
    """The four measurements on ``dev``; returns the rows (also printed)."""
    rows = []
    kind = torch.cuda.get_device_name(dev)

    def record(op, ms, nbytes, ops=0.0, detail="", **extra):
        bound, by = bound_ms(nbytes, ops)
        row = {"op": op, "ms": ms, "bound_ms": bound, "bound_by": by,
               "detail": detail, "device": kind, **extra}
        rows.append(row)
        print(json.dumps(row), flush=True)

    rng = np.random.RandomState(0)
    table = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, H), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, N, (U, S)).astype(np.int32)).to(dev)
    mask = torch.from_numpy((rng.rand(U, S) < 0.9).astype(np.float32)).to(dev)
    flat = idx.reshape(-1)
    j = flat.shape[0]

    # 1. row gather: each distinct row read once, each output row written
    got = gather.gather_rows_kernel(table, flat)
    want = gather.gather_rows_plain(table, flat)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("gather_rows differs from index_select")
    rows_read = int(torch.unique(flat).numel())
    nbytes = rows_read * H * 4 + j * H * 4 + j * 4
    ms = cuda_ms(lambda: gather.gather_rows_kernel(table, flat), reps=50)
    record("gather_rows_cuda_w128_f32", ms, nbytes,
           detail=f"{j} ids, {rows_read} distinct rows over [{N},{H}]: "
                  f"{j / ms / 1e3:.0f}M rows/s; equal to index_select",
           max_abs_err=0.0,
           plain_ms=cuda_ms(lambda: gather.gather_rows_plain(table, flat),
                            reps=50),
           library_ms=cuda_ms(lambda: table.index_select(0, flat), reps=50))

    # 2. gather+mean
    got = agg.mean_aggregate(table, idx, mask)
    err = float((got - agg.mean_aggregate_plain(table, idx, mask)).abs().max())
    weights = mask / mask.sum(1, keepdim=True).clamp_min(1.0)
    valid = mask > 0
    rows_read = int(torch.unique(idx[valid]).numel())
    record("gather_mean_cuda", cuda_ms(
        lambda: agg.mean_aggregate(table, idx, mask), reps=50),
        rows_read * H * 4 + 2 * U * S * 4 + U * H * 4,
        ops=2 * int(valid.sum()) * H,
        detail=f"[{U},{S}] over [{N},{H}]; max abs err vs plain {err}",
        plain_ms=cuda_ms(lambda: agg.mean_aggregate_plain(table, idx, mask),
                         reps=5),
        library_ms=cuda_ms(lambda: F.embedding_bag(
            idx, table, mode="sum", per_sample_weights=weights), reps=20))

    # 3. scatter-add (the gather's backward)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (U, H), dtype=np.float32)).to(dev)
    contrib = (g[:, None, :] * mask[:, :, None]).reshape(-1, H)
    long_idx = flat.long()
    acc = torch.zeros((N, H), device=dev)     # added into, never reset
    nbytes = j * H * 4 + j * 8 + N * H * 4
    ms = cuda_ms(lambda: acc.index_add_(0, long_idx, contrib), reps=20)
    record("scatter_add_index_add", ms, nbytes, ops=j * H,
           detail=f"{j} rows into [{N},{H}]: {j / ms / 1e3:.0f}M rows/s")
    order = torch.argsort(long_idx)
    idx_s, contrib_s = long_idx[order], contrib[order].contiguous()
    record("scatter_add_index_add_presorted", cuda_ms(
        lambda: acc.index_add_(0, idx_s, contrib_s), reps=20),
        nbytes, ops=j * H,
        detail="sorted indices (the sort and permute not counted)")

    # 4. pair scores
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2048, H), dtype=np.float32)).to(dev)
    targets = torch.from_numpy(rng.randint(0, 2048, 512).astype(
        np.int32)).to(dev)
    got = sddmm.pair_scores_kernel(emb, targets)
    err = float((got - sddmm.dense_pair_scores(emb, targets)).abs().max())
    record("pair_scores_cuda", cuda_ms(
        lambda: sddmm.pair_scores_kernel(emb, targets), reps=100),
        2048 * H * 4 + 512 * 4 + 512 * 2048 * 4,
        ops=2 * 512 * 2048 * H + 3 * (2048 + 512) * H,
        detail=f"[512 x 2048] block; max abs err vs plain {err}",
        plain_ms=cuda_ms(lambda: sddmm.dense_pair_scores(emb, targets),
                         reps=50),
        library_ms=cuda_ms(lambda: torch.mm(
            F.normalize(emb[targets.long()], eps=1e-8),
            F.normalize(emb, eps=1e-8).T), reps=50))
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
