"""Graph generator ``power_law``: the algorithm of the port's
``synthetic_power_law`` (``BASELINE.json`` configuration 5), copied so that
the program may change and the yardstick may not.  Edge endpoints are drawn
from a Zipf law of exponent ``alpha`` over node ranks, the ranks permuted so
the hubs are spread out; self-pairs are dropped, both directions inserted
and duplicates removed; CSR sorted by (source, destination).

Configuration keys (``graph``): ``num_nodes``, ``num_edges`` (endpoint pairs
drawn), ``alpha``, ``topology_seed`` (the fixed graph, like a deployment's
data set).
"""

from __future__ import annotations

import torch

from benchmark.graphgen import Graph, csr, generator


def topology(gcfg: dict, device: torch.device) -> Graph:
    return power_law_graph(gcfg["num_nodes"], gcfg["num_edges"],
                           gcfg["alpha"],
                           generator(gcfg["topology_seed"], device))


def power_law_graph(num_nodes: int, num_edges: int, alpha: float,
                    gen: torch.Generator) -> Graph:
    dev = gen.device
    ranks = torch.randperm(num_nodes, generator=gen, device=dev)
    u = torch.rand(2 * num_edges, generator=gen, device=dev,
                   dtype=torch.float64)
    w = (torch.arange(num_nodes, device=dev, dtype=torch.float64)
         + 1.0) ** (-alpha)
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    draws = torch.searchsorted(cdf, u).clamp_(max=num_nodes - 1)
    ends = ranks[draws].view(2, num_edges)
    keep = ends[0] != ends[1]
    src, dst = ends[0][keep], ends[1][keep]
    return csr(num_nodes, torch.unique(torch.cat([src * num_nodes + dst,
                                                   dst * num_nodes + src])))
