"""The MAX aggregator's five-seed quality study at one code version: the
port of the JAX system's ``tools/max_seed_study.py``.

Runs the compact ``Trainer`` (the reference-protocol parity path) on Cora,
supervised, agg MAX, 50 epochs, b_sz 20, best-val -> test (the protocol the
original GraphSAGE implementation's MAX arm was measured under), for each
of the seeds (824, 1, 7, 42, 123), each on ``load_cora(seed=seed)`` (the
split and the synthesized content follow the seed), and summarises the best
val F1 over the seeds: mean, ``std(ddof=1)`` and the 95% CI half-width
t(n-1, .975) * std / sqrt(n) (t(4, .975) = 2.776 for the five seeds).

Writes ``OUR_SUP_MAX_seeds.json`` in the output directory: the JAX tool's
keys (``impl``, ``protocol``, ``dataset``, ``seeds``, ``summary``) and
beside them the card's name and power limit.

    python -m graphsage_torch.max_seed_study [--out DIR] [--device cpu]

Without a card it raises unless ``--device cpu`` is given.  Cora is read
from ``data/cora`` (``graphsage_torch.data.load_cora``); without it the
loader raises ``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import setup_device
from graphsage_torch.data import load_cora
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import Trainer, TrainConfig

SEEDS = (824, 1, 7, 42, 123)
EPOCHS = 50
# t(dof, .975), two-sided 95%: the CI half-width's quantile by seeds - 1
T_975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365, 8: 2.306, 9: 2.262}
PROTOCOL = "sup, {epochs} epochs, b_sz 20, agg MAX, best-val->test"
OUT_FILE = "OUR_SUP_MAX_seeds.json"


def describe(ds) -> str:
    """The record's ``dataset``: the JAX tool's words for Cora."""
    if ds.name in ("cora", "pubmed"):
        content = ("synthesized content" if ds.synthetic_features
                   else "real content")
        return f"{ds.name} (real citation graph, {content})"
    return f"{ds.name} (stand-in: synthetic graph and content)"


def summarize(vals) -> dict:
    """Mean, std (ddof 1) and the 95% CI half-width of the per-seed F1s."""
    v = np.asarray(vals)
    std = float(v.std(ddof=1))
    return {"mean_val_f1": round(float(v.mean()), 4),
            "std": round(std, 4),
            "ci95_halfwidth": round(
                float(T_975[len(v) - 1] * std / np.sqrt(len(v))), 4)}


def run(ds, seeds=SEEDS, epochs: int = EPOCHS, device=None,
        trainers: list | None = None, log=print) -> dict:
    """The record.  ``ds`` is a Dataset for every seed, or a function of
    the seed that returns one (``main``: ``load_cora(seed=seed)``);
    each seed's trainer is appended to ``trainers`` when given."""
    dev = setup_device(device)
    name, limit = bench.card(dev)
    load = ds if callable(ds) else (lambda seed: ds)
    out = {"impl": f"graphsage_torch compact Trainer ({name})",
           "protocol": PROTOCOL.format(epochs=epochs),
           "dataset": None, "seeds": {}, "device": name,
           "power_limit": limit}
    vals = []
    for seed in seeds:
        data = load(seed)
        out["dataset"] = describe(data)
        mcfg = GraphSageConfig(num_layers=2, input_size=data.feature_dim,
                               out_size=128, agg_func="MAX")
        tcfg = TrainConfig(learn_method="sup", epochs=epochs, b_sz=20,
                           seed=seed, verbose=False)
        tr = Trainer(data, mcfg, tcfg, device=dev)
        t0 = time.time()
        tr.fit()
        best = max((h for h in tr.history if "test_f1" in h),
                   key=lambda h: h["val_f1"], default={})
        rec = {"best_val_f1": round(tr.max_vali_f1, 4),
               "test_f1": round(best.get("test_f1", float("nan")), 4),
               "wall_s": round(time.time() - t0, 1)}
        out["seeds"][str(seed)] = rec
        vals.append(tr.max_vali_f1)
        if trainers is not None:
            trainers.append(tr)
        log(f"# seed {seed}: {json.dumps(rec)}")
    out["summary"] = summarize(vals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=bench.DEFAULT_OUT,
                    help="directory of the output file")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    out = run(lambda seed: load_cora(seed=seed), device=dev,
              log=lambda line: print(line, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
