"""The 1M-node step's anatomy on the card: the port of the JAX system's
``tools/profile_bigscale.py``.

On config 5's graph and device-drawn features (``bigscale_bench``), at B
65536 over STEPS = 20 steps of the bench's batch stack, it times:

- ``refresh_ms``: the refresh alone (a warm call, then the mean of 3);
- ``steponly_ms_per_step``: the steps on a held cache
  (``cached.cached_epoch_reuse``), a warm epoch, then one timed;
- ``forward_only_ms_per_step``: ``cached_forward``, the classifier and the
  loss under ``torch.no_grad`` (the JAX tool's ``fwd_only_scan``);
- ``stopgrad_w1_ms_per_step``: the step with the first layer's params
  detached (:class:`StopGradW1Step`), so that neither the h1 table's
  scatter nor the dW1 GEMM runs; it still clips and takes the SGD update,
  which leaves layer 0 unchanged (JAX's ``stopgrad_scan``);
- ``derived``: the JAX tool's three derived numbers, by its formulas.

Beside them, what the JAX tool could only infer: the device's busy time by
kernel and its idle share over one step-only epoch (``torch.profiler``),
and each variant's kernel launches.  Writes ``PROFILE_BIGSCALE.json`` in
the output directory.

    python -m graphsage_torch.profile_bigscale [--out DIR]

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import (DTYPE, FANOUT, HIDDEN,
                                            card_memory, common_args,
                                            device_feats, load_1m,
                                            reset_peak, setup_device,
                                            steponly_epoch)
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models.layers import classifier_apply
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.train import cached
from graphsage_torch.train.dense import cast_compute

BATCH, STEPS = 65536, 20
OUT_FILE = "PROFILE_BIGSCALE.json"


@dataclasses.dataclass(frozen=True)
class StopGradW1Step(cached.CachedStep):
    """A ``CachedStep`` whose forward sees the first layer's params
    detached: its gradient is zero, so the backward stops at layer 1's
    output (no h1-table scatter, no dW1 GEMM), and the clip and the SGD
    update leave layer 0 as it was."""

    def _encode(self, params, feats, cache_feats, cache_count, ids,
                frontiers):
        sage = params["sage"]
        layers = ([{k: v.detach() for k, v in sage["layers"][0].items()}]
                  + list(sage["layers"][1:]))
        return super()._encode({"sage": {**sage, "layers": layers}}, feats,
                               cache_feats, cache_count, ids, frontiers)


def forward_only_epoch(mcfg, fanout: int = FANOUT):
    """``epoch(params, feats, cache_feats, cache_count, hop, batches,
    labels) -> losses [T]``: each step's sampling, encode, classifier and
    loss without a gradient."""

    @torch.no_grad()
    def epoch(params, feats, cache_feats, cache_count, hop, batches, labels):
        losses = []
        for t in range(batches.shape[0]):
            ids, frontiers = cached.sample_cached_frontiers(
                hop, batches[t], mcfg, fanout)
            embs = cached.cached_forward(params, mcfg, feats, cache_feats,
                                         cache_count, ids, frontiers, fanout)
            logp = classifier_apply(cast_compute(params["clf"], mcfg), embs)
            losses.append(supervised_nll(
                logp, labels[t], torch.ones(embs.shape[0],
                                            device=embs.device)))
        return torch.stack(losses)

    return epoch


def stopgrad_epoch(mcfg, fanout: int = FANOUT):
    """The step-only epoch of :class:`StopGradW1Step`."""
    step = StopGradW1Step(mcfg, fanout=fanout)

    def epoch(params, feats, cache_feats, cache_count, hop, batches, labels):
        return cached.cached_epoch_reuse(step, params, feats, cache_feats,
                                         cache_count, hop, batches, labels)

    return epoch


def timed_ms(fn, dev: torch.device, reps: int = 3):
    """A warm call, then ``reps`` calls between two synchronisations:
    (mean ms a call, the launches of those calls)."""
    fn()
    bench.sync(dev)
    agg.reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    bench.sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3, dict(agg.LAUNCHES)


def device_busy(fn, dev: torch.device, top: int = 12):
    """fn() under torch.profiler (the card's kernels): (its result, device
    busy ms, [(kernel, ms, launches)] of the ``top`` costliest kernels),
    busy None on the CPU or where nothing was recorded."""
    if dev.type != "cuda":
        return fn(), None, []
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        bench.sync(dev)
    kernels = sorted(((evt.key, evt.self_device_time_total / 1e3, evt.count)
                      for evt in prof.key_averages()
                      if evt.device_type == DeviceType.CUDA
                      and evt.self_device_time_total),
                     key=lambda k: -k[1])
    if not kernels:
        return out, None, []
    return out, sum(ms for _, ms, _ in kernels), kernels[:top]


def run(ds, pad, feats, dev: torch.device, batch: int = BATCH,
        steps: int = STEPS, hidden: int = HIDDEN, log=print) -> dict:
    reset_peak(dev)
    mcfg, params, feats, hop, batches, labels = bench._setup(
        ds, pad, DTYPE, batch, steps, hidden, dev, feats=feats)
    device, power_limit = bench.card(dev)
    results = {"workload": (f"powerlaw {ds.num_nodes} nodes, D="
                            f"{feats.shape[1]}, H={hidden}, fanout "
                            f"{FANOUT}, table width {pad.width}, bf16 "
                            f"tables"),
               "batch": batch, "device": device, "power_limit": power_limit}
    launches = {}

    def report(name, ms, counts=None):
        results[name] = ms
        if counts is not None:
            launches[name] = counts
        log(f"# {name}: {ms:.6f} ms")

    report("refresh_ms", *timed_ms(
        lambda: cached.refresh_leaf_cache(hop, feats, FANOUT), dev))
    cache = cached.refresh_leaf_cache(hop, feats, FANOUT)
    args = (params, feats, *cache, hop, batches, labels)
    for name, epoch in (("steponly_ms_per_step", steponly_epoch(mcfg)),
                        ("forward_only_ms_per_step",
                         forward_only_epoch(mcfg)),
                        ("stopgrad_w1_ms_per_step", stopgrad_epoch(mcfg))):
        ms, counts = timed_ms(lambda: epoch(*args), dev, reps=1)
        report(name, ms / steps, counts)
    results["launches"] = launches

    step_only = steponly_epoch(mcfg)
    t0 = time.perf_counter()
    step_only(*args)
    bench.sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    _, busy, kernels = device_busy(lambda: step_only(*args), dev)
    results["steponly_epoch_profile"] = {
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": None if busy is None else 1 - busy / wall,
        "by_kernel": [{"kernel": k[:120], "ms": ms, "launches": n}
                      for k, ms, n in kernels]}
    log(f"# step-only epoch: wall {wall:.6f} ms, device busy {busy}")

    results["derived"] = {
        "refresh_amortized_ms_per_step_T20": results["refresh_ms"] / steps,
        "total_ms_per_step": (results["refresh_ms"] / steps
                              + results["steponly_ms_per_step"]),
        "refresh_gather_GBps": (1e7 * 2 * feats.shape[1]
                                / (results["refresh_ms"] / 1e3) / 1e9),
    }
    results.update(card_memory(dev))
    return results


def main(argv=None) -> int:
    args = common_args(__doc__.split("\n\n")[0]).parse_args(argv)
    dev = setup_device(args.device)
    ds, pad, gen_s = load_1m(args.nodes, args.edges)
    print(f"# generated in {gen_s:.1f} s", file=sys.stderr, flush=True)
    feats = device_feats(ds.num_nodes, ds.feature_dim, dev)
    results = run(ds, pad, feats, dev,
                  log=lambda *a: print(*a, file=sys.stderr, flush=True))
    results["host_generation_s"] = gen_s
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
