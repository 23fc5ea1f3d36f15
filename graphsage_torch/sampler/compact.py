"""Compact (deduplicated) batch builder, numpy only.

Port of ``graphsage_tpu/sampler/compact.py``.  Replicates the reference's
sampled-computation-graph construction (src/models.py:246-253 top-down
sampling, :277-289 per-unique-node fanout sampling with the self-union,
:291-308 aggregation index building, :271-275 self-row mapping) and emits
fixed-shape padded index tables (``Frontier``s); union sizes are padded to
power-of-two buckets.

Like the reference, each unique node of a layer is sampled once and every
consumer sees the same sample set.

Two builders, chosen by ``native``:
- the C++ engine (``csrc/gs_native.cpp``, bound by
  ``graphsage_torch.native``), the default.  It draws its seed from ``rng``
  exactly as the JAX package does (``rng.randint(0, 2**63 - 1)``), so one
  ``RandomState`` seed gives both packages bit-identical frontiers.  A
  failed build raises;
- the numpy builder, only when the caller asks for it (``native="never"``)
  or replays recorded sample sets (``sample_sets``).

``shuffle_slots`` permutes each row's slots after either builder
(``shuffle_frontier_slots``), drawing from the same ``rng`` after the
sampling, so the LSTM aggregator's slot order is bit-identical to the JAX
package's too.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.models.graphsage import Frontier


def _bucket(n: int, minimum: int = 32) -> int:
    """Round up to the next power of two (>= minimum), so only O(log U)
    distinct shapes occur."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class CompactBatch:
    """The sampled computation graph of one batch."""
    x0_ids: np.ndarray             # int32 [U0_pad] rows of the feature table
    frontiers: tuple               # bottom-up Frontier tuple (numpy arrays)
    batch_nodes: np.ndarray        # int32 [B] the real (unpadded) batch
    batch_size: int                # = len(batch_nodes)
    out_rows: int                  # padded row count of the output


def _build_compact_batch_native(graph: CSRGraph, batch_nodes: np.ndarray,
                                rng: np.random.RandomState, num_layers: int,
                                fanout: int, gcn: bool) -> CompactBatch:
    """C++ builder: build at worst-case caps, then slice down to bucket
    sizes."""
    from graphsage_torch.native import build_compact_batch_native

    b = len(batch_nodes)
    u_caps = np.zeros(num_layers + 1, dtype=np.int32)
    cap = b
    for d in range(num_layers + 1):
        # bucketed caps guarantee bucket(actual_size) <= cap, so the
        # slice-down below stays within the filled buffers
        u_caps[d] = _bucket(min(graph.num_nodes + b, cap))
        cap *= fanout + 1
    seed = int(rng.randint(0, 2**63 - 1))
    union_sizes, x0_ids_full, layers = build_compact_batch_native(
        graph.indptr, graph.indices, graph.num_nodes,
        batch_nodes.astype(np.int32), num_layers, fanout, gcn, seed, u_caps)

    frontiers = []
    for j, (idx, mask, self_idx) in enumerate(layers):
        u = _bucket(int(union_sizes[num_layers - 1 - j]))
        frontiers.append(Frontier(idx=np.ascontiguousarray(idx[:u]),
                                  mask=np.ascontiguousarray(mask[:u]),
                                  self_idx=np.ascontiguousarray(
                                      self_idx[:u])))
    u0 = _bucket(int(union_sizes[num_layers]))
    return CompactBatch(
        x0_ids=np.ascontiguousarray(x0_ids_full[:u0]),
        frontiers=tuple(frontiers),
        batch_nodes=batch_nodes.astype(np.int32), batch_size=b,
        out_rows=frontiers[-1].idx.shape[0])


def sample_neighbor_sets(graph: CSRGraph, nodes: Sequence[int],
                         rng: np.random.RandomState, fanout: int = 10,
                         ) -> list[set]:
    """Uniform fanout sampling without replacement, take-all below fanout,
    then union the self node in (reference src/models.py:280-285)."""
    out = []
    for v in nodes:
        neigh = graph.neighbors(int(v))
        if len(neigh) >= fanout:
            samp = set(rng.choice(neigh, size=fanout, replace=False).tolist())
        else:
            samp = set(int(x) for x in neigh)
        samp.add(int(v))
        out.append(samp)
    return out


def shuffle_frontier_slots(frontiers, rng: np.random.RandomState) -> tuple:
    """Permute each row's slots (idx and mask together), one
    ``rng.rand(U, S)`` a frontier, bottom-up, ordered by ``argsort``
    (``graphsage_tpu/sampler/compact.py:109-122``): the random neighbour
    order the GraphSAGE paper gives the LSTM aggregator.  Order-invariant
    aggregators are unaffected, and masked slots are skipped wherever they
    land."""
    out = []
    for f in frontiers:
        order = np.argsort(rng.rand(*f.idx.shape), axis=1)
        out.append(Frontier(idx=np.take_along_axis(f.idx, order, axis=1),
                            mask=np.take_along_axis(f.mask, order, axis=1),
                            self_idx=f.self_idx))
    return tuple(out)


def build_compact_batch(graph: CSRGraph, batch_nodes: np.ndarray,
                        rng: np.random.RandomState, num_layers: int = 2,
                        fanout: int = 10, gcn: bool = False,
                        sample_sets: list[list[set]] | None = None,
                        shuffle_slots: bool = False,
                        native: str = "auto") -> CompactBatch:
    """Build the per-layer padded frontiers of a batch.

    sample_sets, when given, is a list (top-down: entry 0 belongs to the
    batch layer) of per-node sample sets *including self*, used verbatim
    instead of fresh sampling: the parity-replay hook.

    shuffle_slots: permute each row's slots with
    :func:`shuffle_frontier_slots` after the build (the LSTM aggregator).

    native: "auto" builds with the C++ engine unless ``sample_sets`` is
    given; "never" takes the numpy builder.
    """
    if native not in ("auto", "never"):
        raise ValueError(f"native must be 'auto' or 'never', not {native!r}")
    batch_nodes = np.asarray(batch_nodes, dtype=np.int64)

    if native == "auto" and sample_sets is None:
        cb = _build_compact_batch_native(graph, batch_nodes, rng,
                                         num_layers, fanout, gcn)
        if shuffle_slots:
            cb = dataclasses.replace(
                cb, frontiers=shuffle_frontier_slots(cb.frontiers, rng))
        return cb

    # --- top-down sampling: union lists (reference src/models.py:246-253)
    levels: list[dict] = [{"nodes": batch_nodes.tolist(), "samp": None}]
    lower = batch_nodes.tolist()
    for depth in range(num_layers):
        if sample_sets is not None:
            samp = sample_sets[depth]
            assert len(samp) == len(lower)
        else:
            samp = sample_neighbor_sets(graph, lower, rng, fanout)
        union: list[int] = []
        seen: set[int] = set()
        for s in samp:
            for n in sorted(s):
                if n not in seen:
                    seen.add(n)
                    union.append(n)
        levels[-1]["samp"] = samp  # samples belong to the level above
        levels.append({"nodes": union, "samp": None})
        lower = union
    # levels[0] = batch (top) ... levels[num_layers] = deepest union

    # --- bottom-up frontier tables
    slot_width = fanout + 1  # a sample set may hold fanout neighbours + self
    frontiers: list[Frontier] = []
    for li in range(num_layers, 0, -1):  # li indexes the *previous* level
        prev_nodes = levels[li]["nodes"]
        cur_nodes = levels[li - 1]["nodes"]
        samp = levels[li - 1]["samp"]
        prev_pos = {n: i for i, n in enumerate(prev_nodes)}

        u_pad = _bucket(len(cur_nodes))
        idx = np.zeros((u_pad, slot_width), dtype=np.int32)
        mask = np.zeros((u_pad, slot_width), dtype=np.float32)
        self_idx = np.zeros(u_pad, dtype=np.int32)
        for r, v in enumerate(cur_nodes):
            self_idx[r] = prev_pos[v]
            # aggregation set: sample plus self, minus self unless gcn
            # (reference src/models.py:285, 297-298)
            members = samp[r] if gcn else (samp[r] - {v})
            for c, n in enumerate(sorted(members)):
                idx[r, c] = prev_pos[n]
                mask[r, c] = 1.0
        frontiers.append(Frontier(idx=idx, mask=mask, self_idx=self_idx))

    deepest = levels[num_layers]["nodes"]
    u0_pad = _bucket(len(deepest))
    x0_ids = np.zeros(u0_pad, dtype=np.int32)
    x0_ids[:len(deepest)] = deepest

    fr = tuple(frontiers)
    if shuffle_slots:
        fr = shuffle_frontier_slots(fr, rng)
    return CompactBatch(
        x0_ids=x0_ids,
        frontiers=fr,
        batch_nodes=batch_nodes.astype(np.int32),
        batch_size=len(batch_nodes),
        out_rows=frontiers[-1].idx.shape[0],
    )
