"""Run one cell of the port's benchmark once.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs from the seed, the program's object, warm-up), a window of
``--seconds``, then the check against the plain reference.  Prints the
numbers compared, each beside its limit, as the last lines of standard
error, and one JSON object as the last line of standard output.  Exits
non-zero, with no result, when there is no CUDA card or fewer than the
cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# loaded by no path of the port; their presence after the window means the
# run measured something else
FORBIDDEN = ("jax", "jaxlib", "flax", "graphsage_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def line(outcome) -> dict:
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": outcome.metrics,
           "device": outcome.device}
    if outcome.breakdown is not None:
        out["breakdown"] = outcome.breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return out


def main(argv=None, device=None, overrides=None) -> int:
    """``device`` and ``overrides`` are for the CPU tests, which skip the
    look for a card and run at small sizes."""
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, overrides)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    outcome = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device(device), STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"loaded {', '.join(bad)}: the port must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line(outcome)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
