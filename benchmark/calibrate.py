"""Readings from which a cell's limits are set: for each seed, one run of
the cell with the numbers that decide ``correct``, those of the control
(the reference in the precision below the configuration's, put in the
program's place) and, for the training cells, those of a planted fault
(half of each batch left out, the mean taken over the rest).  Prints one
JSON line a seed; runs on the card.

    python -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        --seconds 2 [--out FILE]
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    cell = harness.load_cell(args.workload, overrides)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            started = STARTED if i == 0 else time.perf_counter()
            out = harness.run(cell, seed, args.seconds, False,
                              torch.device(device), started, controls=True)
            rec = {"workload": cell.name, "seed": seed,
                   "correct": out.correct,
                   "readings": {c.name: c.value for c in out.checks},
                   **out.controls,
                   "metrics": {k: v["value"] for k, v in out.metrics.items()},
                   "memory_peak_bytes": out.device["memory_peak_bytes"],
                   "kind": out.device["kind"]}
            print(json.dumps(rec), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
            del out
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
