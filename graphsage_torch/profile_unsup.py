"""The unsup cached row's pair-loss block on the card: the port of the JAX
system's ``tools/profile_unsup.py``.

At the bench's unsup shape (U = 32768 encoded rows, B = 4096 targets, P = 6
positive and M = 20 negative pairs each, H = 128, bfloat16) it times the
value and the gradient, with respect to the [U, H] embeddings, of the
"normal" pair loss (``losses._unsup_loss_from_cosines``, Q 10) on three
ways to its cosines:

- ``sddmm_pallas``: the dense [B, U] block from the ``pair_scores`` kernel
  with its analytic backward (``ops.sddmm.PairScores``), pairs sampled out
  of it;
- ``sddmm_xla``: the same block from the plain ``dense_pair_scores``
  (normalised rows and the library matmul, under autograd);
- ``gathered``: ``gathered_pair_cosines``, no [B, U] block.

Each block is a warm call, then the median of ``REPS`` synchronised calls.
``parity_<variant>`` holds the loss and gradient of the first and last
against ``sddmm_xla``'s.  Then on the 100,000-node bench graph, bfloat16,
batch U: ``sup_step_ms`` and ``unsup_step_ms``, a refresh and ``STEPS``
steps (``bench.cached_epoch``; the unsup step on the fixed pairs, through
the production dispatcher ``pair_loss_scores``, which takes the gathered
form at this shape), over ``STEPS``.  The pairs and the embeddings are
drawn from one ``RandomState(3)``, the pairs first (``bench.unsup_pairs``'
stream).  Beside the JAX tool's keys the record names the card and its
power limit and the kernel launches of each timed quantity's first timed
call.  Writes ``PROFILE_UNSUP.json`` in the output directory.

    python -m graphsage_torch.profile_unsup [--out DIR]

Without a card it raises unless ``--device cpu`` is given.  ``--nodes``
and ``--edges`` shrink the graph for tests and CPU drives only; the block
shapes stay.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from graphsage_torch import bench
from graphsage_torch.bigscale_bench import common_args, setup_device
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.losses import _unsup_loss_from_cosines
from graphsage_torch.ops import sddmm

U, B, P, M, H = 32768, 4096, 6, 20, 128
STEPS = 20
REPS = 3
VARIANTS = ("sddmm_pallas", "sddmm_xla", "gathered")
OUT_FILE = "PROFILE_UNSUP.json"
NOTE = ("each block and epoch: a warm call, then the median of REPS calls "
        "between two synchronisations.  unsup_step runs the production "
        "dispatcher (gathered formulation at this shape).")


def block_fn(variant: str, pairs: dict):
    """emb -> (loss, d loss / d emb) of the pair loss on ``variant``'s
    cosines."""
    t, pos_q, neg_q = pairs["target_rows"], pairs["pos_q"], pairs["neg_q"]

    def loss_and_grad(emb):
        leaf = emb.detach().requires_grad_(True)
        if variant == "gathered":
            pos_cos, neg_cos = sddmm.gathered_pair_cosines(leaf, t, pos_q,
                                                           neg_q)
        else:
            score = (sddmm.PairScores.apply(leaf, t)
                     if variant == "sddmm_pallas"
                     else sddmm.dense_pair_scores(leaf, t))
            pos_cos = sddmm.sample_scores(score, pos_q)
            neg_cos = sddmm.sample_scores(score, neg_q)
        loss = _unsup_loss_from_cosines(
            pos_cos, pairs["pos_mask"], neg_cos, pairs["neg_mask"],
            pairs["node_valid"], "normal", 10.0, 0.0)
        grad, = torch.autograd.grad(loss, leaf)
        return loss.detach(), grad

    return loss_and_grad


def block_inputs(dev: torch.device):
    """(pairs, emb [U, H] bfloat16) from one RandomState(3)."""
    rng = np.random.RandomState(3)
    pairs = bench.unsup_pairs(U, dev, B, P, M, rng=rng)
    emb = torch.from_numpy(rng.randn(U, H).astype(np.float32)).to(
        dev, torch.bfloat16)
    return pairs, emb


def run(ds, pad, dev: torch.device, log=print) -> dict:
    device, power_limit = bench.card(dev)
    results = {"shape": {"U": U, "B": B, "P": P, "M": M, "H": H},
               "device": device, "power_limit": power_limit, "note": NOTE}
    launches = {}
    pairs, emb = block_inputs(dev)
    for variant in VARIANTS:
        name = f"block_{variant}_ms"
        dt, _, launches[name], _ = bench.timed_calls(
            lambda: block_fn(variant, pairs)(emb), dev, REPS)
        results[name] = dt * 1e3
        log(f"block {variant}: {dt * 1e3:.6f} ms")
    l_ref, g_ref = block_fn("sddmm_xla", pairs)(emb)
    for variant in ("sddmm_pallas", "gathered"):
        loss, grad = block_fn(variant, pairs)(emb)
        dl = abs(float(loss) - float(l_ref))
        dg = float((grad.float() - g_ref.float()).abs().max())
        results[f"parity_{variant}"] = {"dloss": dl, "dgrad_max": dg}
        log(f"parity {variant}: dloss={dl:.2e} dgrad={dg:.2e}")

    mcfg, params, feats, hop, batches, labels = bench._setup(
        ds, pad, "bfloat16", U, STEPS, H, dev)
    args = (params, feats, hop, batches, labels)
    for name, epoch in (("sup_step_ms", bench.cached_epoch(mcfg)),
                        ("unsup_step_ms",
                         bench.cached_epoch(mcfg, pairs=pairs))):
        dt, _, launches[name], _ = bench.timed_calls(
            lambda: epoch(*args), dev, REPS)
        results[name] = dt / STEPS * 1e3
        log(f"{name}: {results[name]:.6f} ms")
    results["launches"] = launches
    return results


def main(argv=None) -> int:
    ap = common_args(__doc__.split("\n\n")[0])
    ap.set_defaults(nodes=100_000, edges=1_000_000)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)
    ds = synthetic_power_law(args.nodes, args.edges, num_feats=602,
                             num_classes=16, seed=0)
    pad = ds.graph.to_padded_sampled(32, np.random.RandomState(99))
    results = run(ds, pad, dev,
                  log=lambda *a: print(*a, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUT_FILE)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
