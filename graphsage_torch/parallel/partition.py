"""Locality-aware graph partitioning for distributed training.

Port of ``graphsage_tpu/parallel/partition.py`` (numpy only, bit-identical
permutations).  The halo exchange (``parallel/halo.py``) partitions nodes
into contiguous id ranges, so its cost is proportional to how many frontier
rows land on remote shards.  ``bfs_reorder`` gives graph neighbourhoods
nearby ids (a BFS from a low-degree seed per component), so that contiguous
range partitioning of the reordered graph approximates an edge-cut
partitioner at O(E) cost.  ``relabel_dataset`` applies a permutation to the
graph, features, labels and splits alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.data.loaders import Dataset


def bfs_reorder(graph: CSRGraph) -> np.ndarray:
    """Returns perm with perm[old_id] = new_id, BFS order from a minimum-
    degree seed per component (reverse-Cuthill-McKee without the reverse:
    the halo cares about locality, not bandwidth direction)."""
    n = graph.num_nodes
    deg = graph.degrees
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # seeds by ascending degree, so components start at their fringe
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        frontier = [int(seed)]
        order[pos] = seed
        pos += 1
        while frontier:
            nxt: list[int] = []
            for v in frontier:
                for u in graph.neighbors(v):
                    if not visited[u]:
                        visited[u] = True
                        order[pos] = u
                        pos += 1
                        nxt.append(int(u))
            frontier = nxt
    assert pos == n
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


def relabel_graph(graph: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Apply node permutation (perm[old] = new) to CSR adjacency."""
    src_old = np.repeat(np.arange(graph.num_nodes), graph.degrees)
    return CSRGraph.from_edges(graph.num_nodes, perm[src_old],
                               perm[graph.indices], undirected=False)


def relabel_dataset(ds: Dataset, perm: np.ndarray) -> Dataset:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return dataclasses.replace(
        ds,
        graph=relabel_graph(ds.graph, perm),
        features=ds.features[inv],
        labels=ds.labels[inv],
        train_nodes=perm[ds.train_nodes].astype(np.int32),
        val_nodes=perm[ds.val_nodes].astype(np.int32),
        test_nodes=perm[ds.test_nodes].astype(np.int32),
    )


def partition_locality(graph: CSRGraph, n_parts: int) -> float:
    """Fraction of edges whose endpoints fall in the same contiguous-range
    partition, the metric bfs_reorder improves (1.0 = no halo traffic)."""
    rows_per = (graph.num_nodes + n_parts - 1) // n_parts
    src = np.repeat(np.arange(graph.num_nodes), graph.degrees)
    same = (src // rows_per) == (graph.indices // rows_per)
    return float(same.mean()) if len(same) else 1.0
