"""Graph representation and the graph compiler (numpy only).

The port's own copy of ``graphsage_tpu/data/graph.py``: the same code, so
that the same edges and seed give bit-identical tables in both packages
(tests/test_torch_data.py holds them to that).

The reference keeps the graph as a Python ``defaultdict(set)`` adjacency list
and does all sampling with Python set algebra on the hot path (reference
src/dataCenter.py:33, src/models.py:277-289).  Here the graph is compiled
**once** into fixed-shape integer tables:

- ``CSRGraph``: compressed sparse row adjacency (indptr/indices int32), the
  canonical host-side form.  Undirected-ization (both directions inserted,
  reference src/dataCenter.py:40-41) happens at construction.
- ``PaddedAdjacency``: a dense ``[N, P]`` neighbor table padded to the max
  (or capped) degree with a validity count per row.  This is the device-side
  form: serving builds its ``[N, P]`` slot table from it.

Everything downstream (serving, aggregation kernels) consumes these tables;
no Python objects cross the host→device boundary per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row adjacency.  Rows sorted by node id, neighbor
    lists sorted ascending (deterministic; the reference's set iteration
    order is not, which is one reason parity is checked on recorded
    subgraphs rather than RNG emulation — see SURVEY §3 RNG notes)."""

    num_nodes: int
    indptr: np.ndarray  # int32 [N+1]
    indices: np.ndarray  # int32 [E]

    @property
    def num_edges(self) -> int:
        """Directed edge slots (each undirected edge counts twice)."""
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node] : self.indptr[node + 1]]

    @staticmethod
    def from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                   undirected: bool = True) -> "CSRGraph":
        """Build CSR from an edge list.

        With ``undirected=True`` both directions are inserted and duplicate
        edges are removed — the exact semantics of the reference loader
        (src/dataCenter.py:40-41: ``adj_lists[a].add(b); adj_lists[b].add(a)``;
        a Python set dedups repeats).  Self-loops are kept if present in the
        input, as the reference's sets would keep them.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if undirected:
            s = np.concatenate([src, dst])
            d = np.concatenate([dst, src])
        else:
            s, d = src, dst
        # dedup (set semantics) via unique on packed 64-bit keys
        key = s * np.int64(num_nodes) + d
        key = np.unique(key)
        s = (key // num_nodes).astype(np.int64)
        d = (key % num_nodes).astype(np.int64)
        # sort by (src, dst) — unique already returns sorted keys
        counts = np.bincount(s, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(num_nodes=num_nodes,
                        indptr=indptr,
                        indices=d.astype(np.int32))

    def to_padded(self, cap: int | None = None,
                  pad_value: int = 0) -> "PaddedAdjacency":
        """Compile to a dense padded neighbor table.

        ``cap`` limits the per-row width.  Rows with degree > cap keep the
        FIRST ``cap`` neighbors in sorted-CSR order — a BIASED prefix, not
        a uniform subset (``truncated`` records it).  For an unbiased
        degree cap use :meth:`to_padded_sampled`, which draws a uniform
        ``cap``-subset per row; this method is for the exact-table case.
        For the shipped datasets ``cap=None`` (full max degree) is cheap:
        Cora max-deg ≈ 168 → 2708×168 int32 ≈ 1.8 MB.
        """
        deg = self.degrees
        max_deg = int(deg.max()) if self.num_nodes else 0
        width = max_deg if cap is None else min(cap, max_deg)
        width = max(width, 1)
        table = np.full((self.num_nodes, width), pad_value, dtype=np.int32)
        for_deg = np.minimum(deg, width)
        # vectorized fill: flat positions row*width + col, with per-row
        # column offsets derived without a Python loop (ramp minus the
        # repeated row starts)
        rows = np.repeat(np.arange(self.num_nodes), for_deg)
        if len(rows):
            starts = np.zeros(self.num_nodes, dtype=np.int64)
            np.cumsum(for_deg[:-1], out=starts[1:])
            offs = np.arange(len(rows), dtype=np.int64) - starts[rows]
        else:
            offs = np.zeros(0, np.int64)
        table[rows, offs] = self.indices[
            (np.repeat(self.indptr[:-1], for_deg) + offs)]
        return PaddedAdjacency(
            neighbors=table,
            degrees=for_deg.astype(np.int32),
            true_degrees=deg,
            truncated=bool((deg > width).any()),
        )

    def to_padded_sampled(self, cap: int,
                          rng: np.random.RandomState) -> "PaddedAdjacency":
        """Compile to a width-``cap`` table with a UNIFORM random subset per
        row (take-all below cap) — the neighbor cache for power-law
        graphs, where ``to_padded()``'s [N, max_degree] table would be
        hub-dominated (a 20k-degree hub ⇒ an 8 GB table at N=100k).

        Unlike ``to_padded(cap=...)`` (sorted-prefix truncation, biased),
        the subset here is exactly uniform, so sampling K of it afterwards
        remains exactly uniform K-of-degree (the subsample() composition
        argument).  One global O(E log E) lexsort, no Python loops.
        """
        deg = self.degrees
        e = self.num_edges
        width = max(1, min(cap, int(deg.max()) if self.num_nodes else 1))
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64), deg)
        # random order within each row segment: sort by (row, random key);
        # row segments stay contiguous, neighbors shuffle uniformly inside
        order = np.lexsort((rng.rand(e), rows))
        shuffled = self.indices[order]
        pos = np.arange(e, dtype=np.int64) - np.repeat(
            self.indptr[:-1].astype(np.int64), deg)
        keep = pos < width
        new_deg = np.minimum(deg, width).astype(np.int32)
        table = np.zeros((self.num_nodes, width), dtype=np.int32)
        table[rows[keep], pos[keep]] = shuffled[keep]
        return PaddedAdjacency(
            neighbors=table,
            degrees=new_deg,
            true_degrees=deg,
            truncated=bool((deg > width).any()),
        )


@dataclasses.dataclass(frozen=True)
class PaddedAdjacency:
    """Dense [N, P] neighbor table + per-row valid counts.

    ``neighbors[i, :degrees[i]]`` are real neighbor ids; the rest is padding.
    Serving builds its fixed-shape slot table from it (replaces reference
    src/models.py:279 ``to_neighs`` list-of-sets).
    """

    neighbors: np.ndarray      # int32 [N, P]
    degrees: np.ndarray        # int32 [N]  (clipped to P)
    true_degrees: np.ndarray   # int32 [N]  (pre-cap)
    truncated: bool

    @property
    def width(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def num_nodes(self) -> int:
        return int(self.neighbors.shape[0])

    def subsample(self, cap: int,
                  rng: np.random.RandomState) -> "PaddedAdjacency":
        """Random ``cap``-subset per row (take-all below cap).

        Composition of uniform subset draws is uniform: sampling K of the
        cap-subset afterwards is EXACTLY uniform K-of-degree sampling
        (P(any j-set of size K) = [C(deg-K, cap-K)/C(deg,cap)]·1/C(cap,K)
        = 1/C(deg,K)).  Refreshing the subset per epoch gives the classic
        neighbor-cache design: device-side samplers work over a width-cap
        table (5x smaller than Cora's max degree) with unchanged sampling
        semantics per draw.
        """
        n, p = self.neighbors.shape
        if cap >= p:
            return self
        keys = rng.rand(n, p)
        keys[np.arange(p)[None, :] >= self.degrees[:, None]] = np.inf
        order = np.argsort(keys, axis=1)[:, :cap]
        table = np.take_along_axis(self.neighbors, order, axis=1)
        new_deg = np.minimum(self.degrees, cap).astype(np.int32)
        return PaddedAdjacency(
            neighbors=np.ascontiguousarray(table),
            degrees=new_deg,
            true_degrees=self.true_degrees,
            truncated=bool((self.degrees > cap).any()),
        )
