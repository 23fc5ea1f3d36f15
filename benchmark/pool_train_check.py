"""A check of GraphSAGE-pool training at the configuration's widths, on the
card; not a cell of the benchmark.

    python -m benchmark.pool_train_check --seed <n> [--steps 8] [--b_sz 512]

Builds the configuration's graph, features and initial parameters from the
seed (``graphgen``, ``pool.init_params``), trains the port's compact
``Trainer`` (sup, the configuration's compute dtype with float32 masters,
its fanout at both layers, batches of ``--b_sz``, the learning rate and
clipping norm of ``TrainConfig``) for ``--steps`` steps,
recording each step's host batch and the parameters after it, and has the
plain reference (``reference.sage_pool``, float32, TF32 off) follow the same
steps on the recorded draws from the same parameters.  Prints one JSON line:
``loss_gap`` (the worst step's loss against the reference's at the program's
own parameters before that step), ``grad1_gap`` and ``grad1_diff`` (the first
update's gradient, by the worst leaf), ``update_gap`` (the parameters' change
after 3 steps), the same numbers of the control (the reference in the
precision below the configuration's), and the seconds of the steps.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from benchmark import adapt, compare, graphgen, harness, pool
from benchmark.harness import ROOT
from benchmark.training import UPDATE
from benchmark.reference import sage_pool
from benchmark.reference.precision import CONTROL, EXACT
from graphsage_torch.train import Trainer, TrainConfig

CONFIG = "sage_pool_reddit"


def _inputs(labels, pb, cb, device) -> dict:
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    nu = int(pb.num_unique)
    rows = cb.frontiers[-1].idx.shape[0]
    lab = torch.zeros(rows, dtype=torch.long, device=device)
    lab[:nu] = labels[t(pb.unique_nodes[:nu]).long()]
    return {"x0_ids": t(cb.x0_ids),
            "frontiers": [(t(f.idx), t(f.mask), t(f.self_idx))
                          for f in cb.frontiers],
            "labels": lab,
            "row_mask": (torch.arange(rows, device=device) < nu).float()}


def _flat(params) -> list[torch.Tensor]:
    return [t.detach().clone() for t in sage_pool.flat(params)]


def readings(params0, steps, x, lr, clip, prog_losses, prog_after, low):
    """The numbers of one side against the reference: the program's, and
    with ``low`` the control's in its place."""
    def loss(params, step, p):
        return sage_pool.compact_loss(params, x, step, "sup", 0.0, p)

    def follow(p):
        return sage_pool.sgd(params0, [functools.partial(loss, step=s, p=p)
                                       for s in steps], lr, clip)

    p0 = sage_pool.flat(params0)
    exact = [functools.partial(loss, step=s, p=EXACT) for s in steps]

    def at(after):
        return sage_pool.losses_at([p0] + after[:-1], exact)

    ref = follow(EXACT)
    prog = {"losses": prog_losses, "params": prog_after,
            "grad1": [(a - b) / lr for a, b in zip(p0, prog_after[0])]}
    control = follow(low)
    return {name: compare.train_readings(side, ref, p0, at(side["params"]),
                                         UPDATE)
            for name, side in (("program", prog), ("control", control))}


def main(argv=None, device=None, overrides=None) -> int:
    """``device`` and ``overrides`` (the configuration's keys to change)
    run the check on the CPU at a small size, as the tier-1 test
    ``tests/test_torch_pool.py`` does."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--b_sz", type=int, default=512)
    args = ap.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("no CUDA device: the check runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device or "cuda")
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{CONFIG}.json").read_text())
    cfg = harness._merge(cfg, overrides or {})
    m = cfg["model"]
    seeds = graphgen.sub_seeds(args.seed)
    data = graphgen.make_data(cfg, args.seed, dev)
    labels = data.labels
    params0 = pool.init_params(cfg, seeds["params"], dev)
    tcfg = TrainConfig(learn_method="sup", b_sz=args.b_sz,
                       fanout=m["fanout"],
                       seed=seeds["program"], epochs=1, verbose=False)
    ds = adapt.dataset(data, cfg)
    del data
    tr = Trainer(ds, pool.model_config(cfg), tcfg, params=params0,
                 device=dev)
    order = tr.rng.permutation(ds.train_nodes)
    steps, after, losses, seconds = [], [], [], []
    for i in range(args.steps):
        batch = tr._build_train_batch(order[i * args.b_sz:
                                            (i + 1) * args.b_sz])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr._step(*batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        steps.append(_inputs(labels, batch[0], batch[1], dev))
        after.append(_flat(tr.params))
    tr.pair_sampler.close()
    del tr
    x, _ = graphgen.features(cfg["graph"], ds.num_nodes, m["feature_dtype"],
                             seeds["features"], dev)
    found = readings(params0, steps, x, tcfg.lr, tcfg.clip_norm, losses,
                     after, CONTROL[m["compute_dtype"]])
    print(json.dumps({"seed": args.seed, "steps": args.steps,
                      "b_sz": args.b_sz, "losses": losses,
                      "step_s": seconds, **found,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
