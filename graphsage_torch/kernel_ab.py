"""Time two trees' kernels on one card, in turns: the row gather, the
gather-reduce (mean, max), the pair-score block and the ordered bfloat16
scatter-add.

    python -m graphsage_torch.kernel_ab --baseline DIR [--match TEXT]
                                        [--out FILE]

DIR holds another tree of this repository (for example ``git archive`` of
an earlier commit, unpacked under ``build/``).  The script makes the inputs
once, then runs four worker processes in the order baseline, this tree,
this tree, baseline.  Each worker imports ``graphsage_torch`` from its own
tree (so it builds and calls that tree's kernels through that tree's
wrappers) and times every row's shape: ``device_ms`` (the kernel's device
time per launch, ``graphsage_torch.microbench.device_ms``), ``ms`` (CUDA
events around back-to-back calls of the wrapper) and ``host_us`` (the
wrapper's host time per call).  It prints one JSON line per row with the
four turns and their means, and the card's name and power limit.
``--match`` times only the rows whose name holds TEXT.  Needs a card.

The shapes are the rows of PERF.md's kernel table.  The index tables come
from the 100,000-node, 1,000,000-edge power-law graph (``synthetic_power_law``,
seed 0): the serving slot table at width 32 (``RandomState(99)``), and a
refresh-like table of 10 sampled neighbours, self masked
(``RandomState(5)``).  The compact and cached gathers take uniform random
ids at the main path's sizes, the score blocks uniform random targets at
theirs (the ragged block with zero rows and a zero target, as
``chip_smoke.py`` has it); embedding values are random (they do not move
the time).  The ``scatter_rows`` rows (``scatter_rows_kernel(g, idx,
num_rows)`` of each tree: the whole call) take the main path's six shapes
with the refresh-like table's ids, flattened, cut to J and taken mod the
row count, so that they carry the graph's hubs (each row prints its
longest chain); the contributions at masked slots are all-zero, as the
sampler's padding makes them.  The ``gather_max backward`` rows time
``max_aggregate_backward(g, embed, idx, mask, out)`` of each tree (the
tie split and its scatter: every kernel of the call) at the compact MAX
step's layer-2 shape in float32 and bfloat16 and at the dense pipeline's
layer-2 shape (each id once, as a dense frontier has it), over a relu'd
random table, so that zeros tie as they do in a layer's input.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

N, FEATS, HIDDEN, WIDTH, FANOUT = 100_000, 602, 128, 32, 10
# name -> (kernel, table (rows, width, dtype, row stride, column offset),
#          index table, or a score block's targets and zero rows): what
#          each row times
ROWS = {
    "gather_mean serving f32": ("mean", (N, HIDDEN, "float32", 2 * HIDDEN,
                                         HIDDEN), "serving"),
    "gather_mean serving bf16": ("mean", (N, HIDDEN, "bfloat16", 2 * HIDDEN,
                                          HIDDEN), "serving"),
    "gather_mean compact layer 1": ("mean", (32768, HIDDEN, "float32",
                                             2 * HIDDEN, HIDDEN), "layer1"),
    "gather_mean compact layer 2": ("mean", (8192, HIDDEN, "float32", HIDDEN,
                                             0), "layer2"),
    "gather_mean refresh f32": ("mean", (N, FEATS, "float32", FEATS, 0),
                                "refresh"),
    "gather_max serving bf16 layer 1": ("max", (N, FEATS, "bfloat16", FEATS,
                                                0), "serving"),
    "gather_max serving bf16 layer 2": ("max", (N, HIDDEN, "bfloat16",
                                                HIDDEN, 0), "serving"),
    "gather_max refresh f32": ("max", (N, FEATS, "float32", FEATS, 0),
                               "refresh"),
    "gather_rows microbench": ("rows", (N, HIDDEN, "float32", HIDDEN, 0),
                               "microbench"),
    "gather_rows cached (a) full table": ("rows", (N, HIDDEN, "float32",
                                                   HIDDEN, 0), "full_table"),
    "gather_rows cached (b) per occurrence": ("rows", (N, FEATS, "float32",
                                                       FEATS, 0),
                                              "per_occurrence"),
    "pair_scores compact step 20 x 1024": ("scores", (1024, HIDDEN,
                                                      "float32", HIDDEN, 0),
                                           "scores_compact"),
    "pair_scores cached (c) step 20 x 1024": ("scores", (1024, HIDDEN,
                                                         "float32", HIDDEN,
                                                         0),
                                              "scores_cached"),
    "pair_scores 512 x 2048": ("scores", (2048, HIDDEN, "float32", HIDDEN,
                                          0), "scores_512"),
    "pair_scores ragged 3 x 1000, H 100": ("scores", (1000, 100, "float32",
                                                      100, 0),
                                           "scores_ragged"),
    "gather_max backward compact layer 2 f32": ("max_bwd", (
        8192, HIDDEN, "float32", HIDDEN, 0), "layer2"),
    "gather_max backward compact (j) layer 2 bf16": ("max_bwd", (
        8192, HIDDEN, "bfloat16", HIDDEN, 0), "layer2"),
    "gather_max backward dense layer 2 f32": ("max_bwd", (
        45056, HIDDEN, "float32", HIDDEN, 0), "dense_layer2"),
    "gather_max backward dense layer 2 bf16": ("max_bwd", (
        45056, HIDDEN, "bfloat16", HIDDEN, 0), "dense_layer2"),
}
# scatter_rows: name -> (J contributions, rows), width HIDDEN, bfloat16
SCATTER_ROWS = {
    "scatter_rows cached (e) layer-1 backward": (720_896, N),
    "scatter_rows cached (h), (i) layer-1 backward": (360_448, N),
    "scatter_rows dense layer 1 backward": (495_616, N),
    "scatter_rows dense layer 2 backward": (45_056, 45_056),
    "scatter_rows compact (g) layer 1 backward": (90_112, 32_768),
    "scatter_rows compact (g) layer 2 backward": (11_264, 8192),
}
for _name, (_j, _m) in SCATTER_ROWS.items():
    ROWS[_name] = ("scatter", (_m, HIDDEN, "bfloat16", HIDDEN, 0), _name)


def make_inputs(path: Path) -> None:
    """The index tables of every row, saved for the workers."""
    import numpy as np
    import torch

    from graphsage_torch.data import synthetic_power_law
    from graphsage_torch.infer import _slot_table

    ds = synthetic_power_law(N, 1_000_000, num_feats=8, num_classes=16,
                             seed=0)

    def slots(width, seed):
        pad = ds.graph.to_padded_sampled(width, np.random.RandomState(seed))
        return _slot_table(torch.from_numpy(pad.neighbors),
                           torch.from_numpy(pad.degrees), False)

    rng = np.random.RandomState(0)

    def uniform(m, shape):
        idx = torch.from_numpy(rng.randint(0, m, shape).astype(np.int32))
        mask = torch.from_numpy((rng.rand(*shape) < 0.8).astype(np.float32))
        return idx, mask

    def targets(u, b, zero=()):
        t = rng.randint(0, u, b).astype(np.int32)
        if zero:
            t[0] = zero[0]                # a target of zero norm
        return torch.from_numpy(t), torch.tensor(zero, dtype=torch.long)

    refresh_idx, refresh_mask = slots(FANOUT, 5)
    flat_idx, flat_mask = refresh_idx.reshape(-1), refresh_mask.reshape(-1)
    scatter_ids = {}
    for name, (j, m) in SCATTER_ROWS.items():
        ids = (flat_idx[:j] % m).int()
        keep = flat_mask[:j] > 0
        chain = int(torch.bincount(ids[keep].long(), minlength=m).max())
        scatter_ids[name] = (ids, keep, chain)
    torch.save({
        "serving": slots(WIDTH, 99),
        "refresh": (refresh_idx, refresh_mask),
        **scatter_ids,
        "layer1": uniform(32768, (8192, 11)),
        "layer2": uniform(8192, (1024, 11)),
        "microbench": uniform(N, (45056 * 11,)),
        "full_table": uniform(N, (32768 * 11,)),
        "per_occurrence": uniform(N, (512 * 11,)),
        "scores_compact": targets(1024, 20),
        "scores_cached": targets(1024, 20),
        "scores_512": targets(2048, 512),
        "scores_ragged": targets(1000, 3, (0, 17, 999)),
        # a dense frontier's slots: each id of [45056] once
        "dense_layer2": (torch.arange(45056, dtype=torch.int32).reshape(
            4096, 11), uniform(45056, (4096, 11))[1]),
    }, path)


def worker(tree: str, inputs: str, match: str | None) -> None:
    """Time every row (whose name holds ``match``) with the kernels of
    ``tree``; print a JSON object.  A scatter row's device time is every
    kernel of the call."""
    sys.path[0] = os.path.abspath(tree)  # in place of this file's directory
    import torch

    from graphsage_torch.ops import aggregate as agg
    from graphsage_torch.ops import gather, scatter, sddmm

    # this tree's timing helpers, whichever tree the kernels come from
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_timing", Path(__file__).with_name("microbench.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)

    dev = torch.device("cuda")
    tables = {key: tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                         for t in value)
              for key, value in torch.load(inputs).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (kind, (m, d, dtype, stride, offset), key) in ROWS.items():
        if match and match not in name:
            continue
        if kind == "scatter":            # g [J, d], zero at masked slots
            idx, keep, _ = tables[key]
            base = torch.randn((idx.shape[0], d), generator=gen,
                               device=dev).to(getattr(torch, dtype))
            base[~keep] = 0.0
            table = base
            fn, symbol = (lambda: scatter.scatter_rows_kernel(table, idx, m),
                          None)
        else:
            base = torch.randn((m, stride), generator=gen, device=dev).to(
                getattr(torch, dtype))
            table = base[:, offset:offset + d]
            idx, mask = tables[key]
        if kind == "scores":             # (target rows, zero rows)
            table[mask] = 0.0
            fn, symbol = (lambda: sddmm.pair_scores_kernel(table, idx),
                          "pair_scores_kernel")
        elif kind == "max_bwd":          # a relu'd table: zeros tie
            table.clamp_min_(0.0)
            g = torch.randn((idx.shape[0], d), generator=gen,
                            device=dev).to(table.dtype)
            with torch.no_grad():
                h = agg.max_aggregate(table, idx, mask)
            fn, symbol = (lambda: agg.max_aggregate_backward(
                g, table, idx, mask, h), None)
        elif kind == "rows":
            fn, symbol = (lambda: gather.gather_rows_kernel(table, idx),
                          "gather_rows_kernel")
        elif kind != "scatter":
            op = agg.mean_aggregate if kind == "mean" else agg.max_aggregate
            fn, symbol = (lambda: op(table, idx, mask), "gather_reduce_kernel")
        with torch.no_grad():
            out[name] = {"device_ms": timing.device_ms(fn, symbol),
                         "ms": timing.cuda_ms(fn, reps=20),
                         "host_us": timing.host_us(fn)}
        del base, table
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the tree to compare with")
    ap.add_argument("--match", default=None,
                    help="time only the rows whose name holds this text")
    ap.add_argument("--out", default=None,
                    help="also write the rows as a JSON list to this file")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.inputs, args.match)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("graphsage_torch.kernel_ab needs a CUDA card")
    here = Path(__file__).resolve().parent.parent
    inputs = here / "build" / "kernel_ab" / "inputs.pt"
    inputs.parent.mkdir(parents=True, exist_ok=True)
    make_inputs(inputs)
    turns = []
    for label in ("baseline", "this tree", "this tree", "baseline"):
        tree = args.baseline if label == "baseline" else str(here)
        proc = subprocess.run(
            [sys.executable, __file__, "--baseline", args.baseline,
             "--worker", tree, "--inputs", str(inputs)]
            + (["--match", args.match] if args.match else []),
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"worker ({label}, {tree}) failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        turns.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    chains = torch.load(inputs)
    rows = []
    for name in ROWS:
        if args.match and args.match not in name:
            continue
        row = {"row": name}
        if name in SCATTER_ROWS:
            row["longest_chain"] = chains[name][2]
        for metric in ("device_ms", "ms", "host_us"):
            values = [(label, t[name][metric]) for label, t in turns]
            row[metric] = [v for _, v in values]
            for side in ("baseline", "this tree"):
                side_values = [v for label, v in values if label == side]
                row[f"{metric} {side}"] = sum(side_values) / len(side_values)
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; turns: baseline, this tree, this tree, baseline")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
