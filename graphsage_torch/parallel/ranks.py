"""Run one function on P gloo ranks on the CPU, one process each.

The measurement modules' counterpart of the JAX tools' virtual CPU
devices (``halo_overhead virtual``, ``scaling_bench --device cpu``), and
the launcher of the distributed tests' ranks: the parent builds every host array, pickles ``payload`` once into a temporary
directory, and starts ``python -m graphsage_torch.parallel.ranks`` for each
rank.  Each rank joins a gloo group over a ``file://`` rendezvous in that
directory (no port to pick), with ``threads`` intra-op threads, no card
(``CUDA_VISIBLE_DEVICES`` empty) and the repository on its path, calls
``fn(payload, rank, world)`` (``fn`` named as ``"module:function"``) and
pickles its result.

    results = run_ranks("graphsage_torch.halo_overhead:virtual_rank",
                        payload, world=4)

A rank that fails, or a run that outlives ``timeout_s`` (also the group's
collective timeout), raises ``RuntimeError`` with the ranks' output; no
rank outlives the call.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(fn: str, payload, world: int, threads: int | None = None,
              timeout_s: float = 600.0) -> list:
    """``fn(payload, rank, world)`` on ``world`` gloo ranks; their results,
    rank 0 first.  ``threads`` per rank defaults to the host's cores over
    ``world`` (at least 1)."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": str(threads),
           "PYTHONPATH": os.pathsep.join(
               p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    with tempfile.TemporaryDirectory(prefix="gs_ranks_") as tmp:
        job = os.path.join(tmp, "payload.pkl")
        with open(job, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        procs, logs, outs = [], [], []
        for rank in range(world):
            outs.append(os.path.join(tmp, f"out_{rank}.pkl"))
            logs.append(open(os.path.join(tmp, f"log_{rank}.txt"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "graphsage_torch.parallel.ranks", job,
                 fn, str(rank), str(world), os.path.join(tmp, "rdzv"),
                 outs[-1], str(threads), str(timeout_s)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env,
                cwd=_ROOT))
        deadline = time.monotonic() + timeout_s
        try:
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
        text = []
        for rank, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {rank} (rc {procs[rank].returncode})\n"
                        + log.read()[-3000:])
            log.close()
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"{fn} on {world} gloo ranks failed:\n"
                               + "\n".join(text))
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    return results


def main(argv) -> int:
    job, fn, rank, world, rendezvous, out, threads, timeout_s = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(threads))
    module, name = fn.split(":")
    target = getattr(importlib.import_module(module), name)
    with open(job, "rb") as f:
        payload = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    try:
        result = target(payload, rank, world)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
