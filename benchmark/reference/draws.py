"""Checks of the program's random draws against the benchmark's own graph.

The reference follows the program step by step through its draws (the
device hop sampler's neighbour samples, the host engine's compact
frontiers, the pair sampler's walks and negatives, the trainer's batch
order), so those draws are checked here by themselves: every drawn
neighbour is a neighbour, rows draw min(degree, K) distinct ones, the
positives are walk steps onto train nodes, the negatives train nodes
outside the target's 5-hop neighbourhood, the extended batch is the union
of the pairs' endpoints, and an epoch's batches cover the train split once.
Each function returns a count of faults; the limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch


def hop_faults(edge_keys: torch.Tensor, n: int, degrees: torch.Tensor,
               nodes: torch.Tensor, samples: torch.Tensor,
               valid: torch.Tensor, fanout: int, first: bool = True) -> int:
    """Rows of a neighbour draw ``samples`` / ``valid`` [M, K] of ``nodes``
    [M] that break the rules; ``first``: the valid slots lead the row."""
    nodes, s = nodes.long(), samples.long()
    want = degrees[nodes].clamp(max=fanout)
    bad = valid.sum(1) != want
    slot = torch.arange(s.shape[1], device=s.device)
    if first:
        bad |= (valid != (slot[None, :] < want[:, None])).any(1)
    keys = nodes[:, None] * n + s
    pos = torch.searchsorted(edge_keys, keys).clamp_(max=edge_keys.numel() - 1)
    bad |= (valid & (edge_keys[pos] != keys)).any(1)
    marked = torch.where(valid, s, -1 - slot[None, :]).sort(1).values
    bad |= (marked[:, 1:] == marked[:, :-1]).any(1)
    return int(bad.sum())


def compact_faults(edge_keys: torch.Tensor, n: int, degrees: torch.Tensor,
                   x0_ids: torch.Tensor, frontiers, top_ids: torch.Tensor,
                   fanout: int) -> int:
    """A compact batch: bottom-up frontiers [(idx, mask, self_idx)] over
    the rows of ``x0_ids``, whose real top rows are the nodes ``top_ids``.
    Each real row draws its node's neighbours, and each level holds every
    node it references once."""
    ids = [x0_ids.long()]
    for _, _, self_idx in frontiers:
        ids.append(ids[-1][self_idx.long()])
    faults = int(not torch.equal(ids[-1][:top_ids.numel()], top_ids.long()))
    real = torch.arange(top_ids.numel(), device=x0_ids.device)
    for level in range(len(frontiers) - 1, -1, -1):
        idx, mask, self_idx = frontiers[level]
        rows, valid = idx[real].long(), mask[real] > 0
        faults += hop_faults(edge_keys, n, degrees, ids[level + 1][real],
                             ids[level][rows], valid, fanout, first=False)
        real = torch.unique(torch.cat([self_idx[real].long(), rows[valid]]))
        faults += int(torch.unique(ids[level][real]).numel() != real.numel())
    return faults


def closure(indptr: np.ndarray, indices: np.ndarray, root: int,
            depth: int) -> np.ndarray:
    """Nodes within ``depth`` hops of ``root``, itself included (bool [N])."""
    seen = np.zeros(len(indptr) - 1, bool)
    seen[root] = True
    frontier = np.array([root])
    for _ in range(depth):
        if frontier.size == 0:
            break
        lo, hi = indptr[frontier], indptr[frontier + 1]
        counts = hi - lo
        offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                   counts)
        nb = np.unique(indices[np.repeat(lo, counts) + offs])
        frontier = nb[~seen[nb]]
        seen[frontier] = True
    return seen


def pair_faults(indptr: np.ndarray, indices: np.ndarray,
                train: np.ndarray, pb, num_neg: int, depth: int,
                mode: str) -> int:
    """An extended batch (the program's ``PairBatch`` fields): its rows the
    union of the targets and their pairs' endpoints, once each; positives
    one-hop walk steps onto train nodes other than the target; negatives
    distinct train nodes outside the target's ``depth``-hop closure
    ("exact": min(num_neg, such nodes) of them) or, "uniform", outside its
    one-hop neighbourhood; ``node_valid`` where both exist."""
    nu = int(pb.num_unique)
    uniq = np.asarray(pb.unique_nodes[:nu]).astype(np.int64)
    faults = int(np.unique(uniq).size != nu)
    targets = uniq[np.asarray(pb.target_rows)]
    ends = [targets]
    for b, t in enumerate(targets):
        nbrs = indices[indptr[t]:indptr[t + 1]]
        pos = uniq[np.asarray(pb.pos_q[b])[np.asarray(pb.pos_mask[b]) > 0]]
        neg = uniq[np.asarray(pb.neg_q[b])[np.asarray(pb.neg_mask[b]) > 0]]
        ends += [pos, neg]
        faults += int(not (np.isin(pos, nbrs).all() and train[pos].all()
                           and (pos != t).all()))
        faults += int(np.unique(neg).size != neg.size or not train[neg].all())
        if mode == "exact":
            far = train & ~closure(indptr, indices, int(t), depth)
            faults += int(neg.size != min(num_neg, int(far.sum()))
                          or not far[neg].all())
        else:
            faults += int(np.isin(neg, nbrs).any() or (neg == t).any())
        faults += int(float(pb.node_valid[b]) != float(pos.size > 0
                                                       and neg.size > 0))
    faults += int(not np.array_equal(np.unique(np.concatenate(ends)),
                                     np.unique(uniq)))
    return faults
