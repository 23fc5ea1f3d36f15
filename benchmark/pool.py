"""What the GraphSAGE-pool cells need beyond the shared inputs: the pool
model's parameters from the seed, the program's configuration, and the
operations and bytes of a serving pass.

The shared yardstick (``graphgen``, ``counts``, ``adapt``) draws and counts
the MEAN / MAX layout, [H, 2 D] layer weights and no pool MLP; this module
adds the pool layout beside it and leaves those as they are.

- ``init_params``: one call a leaf from the seed's ``params`` stream, layer
  by layer: the sage weight [H, D + P] (xavier-uniform), the pool weight
  [P, D] (xavier-uniform), the pool bias [P] (U(+-1 / sqrt(D)), the default
  of a linear layer: a trained pool MLP's bias is not zero, and the check
  must see the program add it); then the classifier as
  ``graphgen.init_params`` draws it.
- ``model_config``: the program's ``GraphSageConfig`` of a POOL
  configuration (``adapt.model_config`` has no pool width).
- ``pass_counts``: the algorithm's matmul operations of a full-graph pass
  (the pool GEMM over every row once, and the sage layer's [self || max]
  product, per layer), the least seconds of its aggregations (each
  distinct P-wide pooled row read once, the index, the degrees and the
  output once, ``counts.aggregate_bytes``) and the least seconds of its
  pool transforms: the larger of the bytes at 3.35 TB/s (the layer's input
  table read once, the float32 weight and bias, the bfloat16 output written
  once) and the algorithm's 2 N K P operations at the dtype's peak; the
  three-piece split is the implementation's work and is not counted.
"""

from __future__ import annotations

import math

import torch

from benchmark import counts, graphgen
from graphsage_torch.models.graphsage import GraphSageConfig


def init_params(cfg: dict, seed: int, device: torch.device) -> dict:
    m, g = cfg["model"], cfg["graph"]
    gen = graphgen.generator(seed, device)

    def uniform(shape, a):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * a

    def xavier(shape):
        return uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])))

    h, p = m["hidden"], m["pool_size"]
    layers, pool = [], []
    for i in range(m["num_layers"]):
        d = g["num_feats"] if i == 0 else h
        layers.append({"weight": xavier((h, d + p))})
        pool.append({"weight": xavier((p, d)),
                     "bias": uniform((p,), 1.0 / math.sqrt(d))})
    return {"sage": {"layers": layers, "pool": pool},
            "clf": {"weight": xavier((g["num_classes"], h)),
                    "bias": uniform((g["num_classes"],),
                                    1.0 / math.sqrt(h))}}


def model_config(cfg: dict) -> GraphSageConfig:
    m, g = cfg["model"], cfg["graph"]
    return GraphSageConfig(num_layers=m["num_layers"],
                           input_size=g["num_feats"], out_size=m["hidden"],
                           gcn=False, agg_func=m["agg_func"],
                           compute_dtype=m["compute_dtype"],
                           pool_size=m["pool_size"])


def pass_counts(cfg: dict, table: torch.Tensor, degrees: torch.Tensor,
                itemsize: int) -> dict:
    """{"flops_per_pass", "agg_bound_s_per_pass", "pool_bound_s_per_pass"}
    of a full-graph pass over the neighbour ``table`` [N, S] (its first
    ``degrees`` slots valid, a node's own id left out)."""
    m, g = cfg["model"], cfg["graph"]
    n, width = table.shape
    slot = torch.arange(width, device=table.device)
    valid = ((slot[None, :] < degrees[:, None])
             & (table != torch.arange(n, device=table.device)[:, None]))
    distinct = int(torch.unique(table[valid]).numel())
    h, p = m["hidden"], m["pool_size"]
    peak = counts.PEAK_FLOPS[m["compute_dtype"]]
    flops, agg_s, pool_s = 0, 0.0, 0.0
    for layer in range(m["num_layers"]):
        d = g["num_feats"] if layer == 0 else h
        pool_flops = 2 * n * d * p
        flops += pool_flops + 2 * n * (d + p) * h
        agg_s += counts.bound_s(counts.aggregate_bytes(
            distinct, p * itemsize, n, width, p * itemsize))
        pool_bytes = n * d * itemsize + p * d * 4 + p * 4 + n * p * itemsize
        pool_s += max(counts.bound_s(pool_bytes), pool_flops / peak)
    return {"flops_per_pass": flops, "agg_bound_s_per_pass": agg_s,
            "pool_bound_s_per_pass": pool_s}
