"""Neighbour sampling on the device, for the leaf-cached pipeline.

Port of ``graphsage_tpu/sampler/device.py``.  For every frontier node, draw
uniform keys over its padded adjacency row, push invalid slots to +inf and
take the ``fanout`` smallest keys: uniform sampling without replacement,
with the take-all rule below the fanout falling out of the mask (take-all
still returns the row in random order).  Each occurrence of a node samples
independently and the tree is expanded densely ([B] -> [B·(K+1)] -> ...).

``torch.Generator`` cannot reproduce ``jax.random``'s streams, so sampling
goes through a *hop sampler*, a callable ``hop(nodes, fanout) -> (samples
[M, fanout] int32, valid [M, fanout] bool)``.  ``HopSampler`` draws from one
generator on the tables' device; the tests give the cached pipeline a hop
that replays the JAX package's draws, and a run on the card can record
the draws and replay them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphsage_torch.models.graphsage import Frontier


def _sample_one_hop(generator: torch.Generator, neighbors: torch.Tensor,
                    degrees: torch.Tensor, nodes: torch.Tensor, fanout: int):
    """Sample ``fanout`` neighbours without replacement for each node.

    neighbors: [N, P] padded adjacency, degrees: [N], nodes: [M].
    Returns (samples [M, fanout] int32, valid [M, fanout] bool); ``valid``
    marks the first min(degree, fanout) slots."""
    nodes = nodes.long()
    rows = neighbors[nodes]                                    # [M, P]
    deg = degrees[nodes].long()                                # [M]
    m, p = rows.shape
    keys = torch.rand((m, p), generator=generator, device=rows.device)
    slot = torch.arange(p, device=rows.device)
    keys = torch.where(slot[None, :] < deg[:, None], keys, torch.inf)
    # the k smallest keys = uniform sampling without replacement; below the
    # fanout the same top-k over all slots returns the whole row in random
    # order, valid slots first (their keys are finite)
    kk = min(fanout, p)
    picked = torch.topk(keys, kk, dim=1, largest=False, sorted=True).indices
    samples = torch.gather(rows, 1, picked)
    if kk < fanout:
        samples = F.pad(samples, (0, fanout - kk))
    valid = (torch.arange(fanout, device=rows.device)[None, :]
             < deg.clamp(max=fanout)[:, None])
    return samples.to(torch.int32), valid


class HopSampler:
    """One-hop draws from ``generator`` over a padded adjacency that lies on
    the generator's device."""

    def __init__(self, neighbors: torch.Tensor, degrees: torch.Tensor,
                 generator: torch.Generator):
        self.neighbors = neighbors
        self.degrees = degrees
        self.generator = generator

    def __call__(self, nodes: torch.Tensor, fanout: int):
        return _sample_one_hop(self.generator, self.neighbors, self.degrees,
                               nodes, fanout)


def sample_frontiers_dense(hop, batch: torch.Tensor, num_layers: int = 2,
                           fanout: int = 10, gcn: bool = False):
    """Expand a batch into dense per-occurrence frontiers.

    Returns (x0_ids [B·(K+1)^L] int32, frontiers bottom-up list of
    ``Frontier``); ``hop`` is called once per depth, top-down.

    Mask semantics match the reference's set dance (src/models.py:285,
    297-298): the aggregation set is sample ∪ {self} minus self unless gcn;
    sampled ids equal to self are masked so gcn mode never double-counts.
    """
    k = fanout
    per_level_nodes = [batch.to(torch.int32)]
    per_level_valid = []  # aggregation masks, top-down
    for _ in range(num_layers):
        nodes = per_level_nodes[-1]
        samples, valid = hop(nodes, k)                         # [M, K]
        per_level_valid.append(valid & (samples != nodes[:, None]))
        # child layout per node: [self, K samples] -> flat [M*(K+1)]
        children = torch.cat([nodes[:, None], samples], dim=1)
        per_level_nodes.append(children.reshape(-1))

    frontiers = []
    for depth in range(num_layers - 1, -1, -1):  # bottom-up
        m = per_level_nodes[depth].shape[0]
        dev = per_level_nodes[depth].device
        base = torch.arange(m, dtype=torch.int32, device=dev) * (k + 1)
        slots = torch.arange(k + 1, dtype=torch.int32, device=dev)
        idx = base[:, None] + slots[None, :]     # slot 0 = self
        first = torch.full((m, 1), 1.0 if gcn else 0.0, device=dev)
        mask = torch.cat([first, per_level_valid[depth].float()], dim=1)
        frontiers.append(Frontier(idx=idx, mask=mask, self_idx=base))
    return per_level_nodes[-1], frontiers
