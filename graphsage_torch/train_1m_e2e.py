"""Training end to end at config-5 scale on one card: the port of the JAX
system's ``tools/train_1m_e2e.py``.

The real ``CachedTrainer`` on 1,000,000 nodes and 10,000,000 edges:
``synthetic_power_law(1_000_000, 10_000_000, num_feats=64)`` (the host's
class-correlated features, uploaded, so that val and test F1 mean
something; 64 wide as in the JAX tool), a 2-layer MEAN model of hidden 128
in bfloat16, sup on plain batches of 65536 (``extend_batches=False``),
table_cap 32, seed 824, ``refresh_every=4``.  The tool's own loop: per
epoch ``train_epoch`` then ``evaluate`` (val F1, and test F1 when val
improves), with the train and eval wall times and the train edges/s
(T · edges_per_batch / train wall; T = ceil(train split / b_sz)).  Beside
the JAX record's keys: the card and its power limit, the trainer's
negative mode and its far-list prewarm (a background thread in "exact"
mode only), per epoch its step losses and the peak of
``torch.cuda.max_memory_allocated``, and ``idle_probe``: one more train
epoch after the timed ones, under ``torch.profiler`` (the card's kernels
only), whose device busy time against the last timed epoch's wall gives
the idle share (tracing slows the host, so the traced epoch is not one of
the timed ones).  Writes
``TRAIN1M.json`` and the trainer's metrics ``TRAIN1M.metrics.jsonl`` in the
output directory.

    python -m graphsage_torch.train_1m_e2e [--epochs 6] [--out DIR]

Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import sys
import time

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import (CLASSES, card_memory,
                                            common_args, reset_peak,
                                            setup_device)
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.profile_bigscale import device_busy
from graphsage_torch.train import CachedTrainer, TrainConfig
from graphsage_torch.train.dense import edges_per_batch

FEATS, B_SZ, EPOCHS, REFRESH_EVERY = 64, 65536, 6, 4
OUT_FILE, METRICS_FILE = "TRAIN1M.json", "TRAIN1M.metrics.jsonl"


def load(nodes: int, edges: int):
    """(the 64-wide dataset, host seconds)."""
    t0 = time.time()
    ds = synthetic_power_law(nodes, edges, num_feats=FEATS,
                             num_classes=CLASSES, seed=0)
    return ds, time.time() - t0


def run(ds, dev, out_dir: str, epochs: int = EPOCHS, b_sz: int = B_SZ,
        gen_s: float | None = None, edges: int | None = None, log=print):
    """Train and evaluate ``epochs`` epochs on ``ds`` (made with ``edges``
    edges); returns (record, trainer)."""
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=128, compute_dtype="bfloat16")
    os.makedirs(out_dir, exist_ok=True)
    metrics = os.path.join(out_dir, METRICS_FILE)
    if os.path.exists(metrics):
        os.remove(metrics)
    tcfg = TrainConfig(learn_method="sup", epochs=epochs, b_sz=b_sz,
                       seed=824, verbose=False, refresh_every=REFRESH_EVERY,
                       metrics_path=metrics)
    t0 = time.time()
    tr = CachedTrainer(ds, mcfg, tcfg, table_cap=32, extend_batches=False,
                       device=dev)
    setup_s = time.time() - t0
    log(f"# trainer setup (with the feature upload) {setup_s:.1f} s")
    prewarm = tr.pair_sampler._prewarm_thread
    prewarm_s = None

    history = []
    batch_edges = edges_per_batch(b_sz, mcfg.num_layers, tcfg.fanout)
    steps = -(-len(ds.train_nodes) // b_sz)
    for ep in range(epochs):
        tr.epoch = ep
        reset_peak(dev)
        t1 = time.time()
        loss = tr.train_epoch()
        train_s = time.time() - t1
        t1 = time.time()
        tr.evaluate()
        eval_s = time.time() - t1
        rec = {"epoch": ep, "mean_loss": loss,
               "train_wall_s": train_s, "eval_wall_s": eval_s,
               "edges_per_sec": steps * batch_edges / train_s,
               "val_f1": tr.history[-1]["val_f1"]}
        if "test_f1" in tr.history[-1]:
            rec["test_f1"] = tr.history[-1]["test_f1"]
        rec.update(step_losses=tr.step_losses, **card_memory(dev))
        if (prewarm is not None and prewarm_s is None
                and not prewarm.is_alive()):
            prewarm_s = time.time() - t0 - setup_s
        history.append(rec)
        log("#", json.dumps(rec))

    # one more train epoch under the profiler, for the device's busy time:
    # its idle share is taken against the last timed epoch's wall (the
    # same work), since tracing slows the host
    tr.epoch = epochs
    t1 = time.time()
    _, busy_ms, kernels = device_busy(tr.train_epoch, dev)
    probe = {"epoch": epochs, "traced_wall_s": time.time() - t1,
             "device_busy_s": None if busy_ms is None else busy_ms / 1e3,
             "by_kernel": [{"kernel": k[:120], "ms": ms, "launches": c}
                           for k, ms, c in kernels]}
    probe["idle_share"] = (None if busy_ms is None else
                           1 - probe["device_busy_s"] / train_s)
    log("# idle probe", json.dumps(probe))
    device, power_limit = bench.card(dev)
    record = {
        "workload": {"nodes": ds.num_nodes, "edges": edges,
                     "feat_dim": ds.feature_dim, "classes": ds.num_classes,
                     "b_sz": b_sz, "steps_per_epoch": steps,
                     "refresh_every": REFRESH_EVERY, "dtype": "bfloat16",
                     "pipeline": "cached"},
        "graph_generation_s": gen_s,
        "trainer_setup_s": setup_s,
        "best_val_f1": tr.max_vali_f1,
        "epochs": history,
        "device": device, "power_limit": power_limit,
        "negative_mode": tr.pair_sampler.negative_mode,
        # the far lists' background build ("exact" mode only): seconds from
        # the trainer's setup to the first epoch end that found it done
        "prewarm_s": prewarm_s,
        "idle_probe": probe,
        "note": ("CachedTrainer end to end (train, then best-val->test "
                 "evaluation each epoch) at config-5 scale on one card; "
                 "edges_per_sec is the train phase only, host batch "
                 "building and the refresh_every=4 refresh share included; "
                 "idle_probe is one more train epoch, after the timed "
                 "ones, under torch.profiler"),
    }
    return record, tr


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds, gen_s = load(args.nodes, args.edges)
    print(f"# graph+features {gen_s:.1f} s", file=sys.stderr, flush=True)
    record, tr = run(ds, dev, args.out, args.epochs, gen_s=gen_s,
                     edges=args.edges,
                     log=lambda *a: print(*a, file=sys.stderr, flush=True))
    tr.pair_sampler.close()
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
