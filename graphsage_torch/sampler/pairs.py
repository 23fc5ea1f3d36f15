"""Positive/negative pair sampling for the unsupervised objectives.

Port of ``graphsage_tpu/sampler/pairs.py``; for one ``RandomState`` seed it
gives bit-identical ``PairBatch``es.  Reference semantics
(src/models.py:45-186):
- constants Q=10, N_WALKS=6, WALK_LEN=1, N_WALK_LEN=5, MARGIN=3
  (src/models.py:49-53);
- positives: N_WALKS random walks of WALK_LEN steps per node; a step landing
  on a train node other than the start records a pair, duplicates included,
  isolated nodes skipped (src/models.py:169-186);
- negatives: train nodes outside the node's <= N_WALK_LEN-hop BFS
  neighbourhood, sampled without replacement (num_neg of them, or all if
  fewer) (src/models.py:153-167);
- the batch is *extended* to the union of all pair endpoints, for every
  learn method (src/models.py:135-148, src/utils.py:149).

Sampling runs on the host.  Each node's far list (the exact negatives'
pool) is cached under an LRU byte budget, so a train node's BFS runs about
once per process.  BFS closures, far lists and uniform negatives come from
the C++ engine (``graphsage_torch.native``); its build failing raises.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict

import numpy as np

from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.native import (bfs_closure_native, far_lists_native,
                                    uniform_negatives_native)
from graphsage_torch.sampler.compact import _bucket

_FAR_CACHE_BYTES = 256 << 20   # the far lists' LRU budget


@dataclasses.dataclass(frozen=True)
class PairBatch:
    """Fixed-shape pair tables for one (extended) batch.

    Every index points at a row of the extended batch's embedding matrix
    (row order = ``unique_nodes``).  Every pair's left side is its batch
    node: (p, q) = (target_rows[b], *_q[b, j])."""
    unique_nodes: np.ndarray   # int32 [U_pad]; first num_unique real
    num_unique: int
    target_rows: np.ndarray    # int32 [B] row of each original batch node
    pos_q: np.ndarray          # int32 [B, P]
    pos_mask: np.ndarray       # float32 [B, P]
    neg_q: np.ndarray          # int32 [B, M]
    neg_mask: np.ndarray       # float32 [B, M]
    node_valid: np.ndarray     # float32 [B]  (>= 1 pos and >= 1 neg pair)


class PairSampler:
    """Host-side walk/negative sampler with cached far lists."""

    def __init__(self, graph: CSRGraph, train_nodes: np.ndarray,
                 q: int = 10, n_walks: int = 6, walk_len: int = 1,
                 n_walk_len: int = 5, margin: float = 3.0,
                 negative_mode: str = "auto"):
        """negative_mode:
        - "exact": reference semantics, negatives are train nodes outside
          the <= n_walk_len-hop BFS neighbourhood; one BFS per distinct
          target, its far list cached under ``_FAR_CACHE_BYTES`` (LRU).
        - "uniform": negatives drawn uniformly from the train nodes other
          than the target and its 1-hop neighbours.
        - "auto": exact when the estimated first-epoch closure cost,
          n_train * E / (300M edge visits/s per core), fits the budget
          ``GS_EXACT_NEG_BUDGET_S`` (default 180 s), else uniform; the JAX
          package's rule (``pairs.py:111-118``), kept for parity.  It
          depends on the host's core count.
        """
        self.graph = graph
        self.q = q
        self.n_walks = n_walks
        self.walk_len = walk_len
        self.n_walk_len = n_walk_len
        self.margin = margin
        self.train_nodes = np.asarray(train_nodes, dtype=np.int64)
        self.train_set = set(self.train_nodes.tolist())
        # LRU far-list cache: node -> int32 train nodes outside its
        # closure; at most _FAR_CACHE_BYTES held
        self._far_cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._far_cache_bytes = 0
        # guards the cache: the prewarm thread fills it while the training
        # thread samples batches; BFS work runs outside the lock
        self._cache_lock = threading.Lock()
        self._prewarm_thread: threading.Thread | None = None
        self._prewarm_stop = threading.Event()
        if negative_mode == "auto":
            budget_s = float(os.environ.get("GS_EXACT_NEG_BUDGET_S", "180"))
            rate = 300e6 * max(1, os.cpu_count() or 1)  # edge-visits/s
            est_s = len(self.train_nodes) * len(graph.indices) / rate
            negative_mode = "exact" if est_s <= budget_s else "uniform"
        if negative_mode not in ("exact", "uniform"):
            raise ValueError(f"unknown negative_mode {negative_mode!r}")
        self.negative_mode = negative_mode

    # ---- BFS closure (reference src/models.py:154-162) -> cached far list
    def _far_nodes(self, node: int) -> np.ndarray:
        with self._cache_lock:
            cached = self._far_cache.get(node)
            if cached is not None:
                self._far_cache.move_to_end(node)
                return cached
        g = self.graph
        bits = bfs_closure_native(g.indptr, g.indices, g.num_nodes, node,
                                  self.n_walk_len)
        close = np.unpackbits(bits, count=g.num_nodes).astype(bool)
        far = self.train_nodes[~close[self.train_nodes]].astype(np.int32)
        self._insert_far(node, far)
        return far

    def _insert_far(self, node: int, far: np.ndarray) -> None:
        # the prewarm and training threads both build outside the lock, so
        # the same key can be inserted twice: credit back the replaced
        # entry's bytes or the budget counter drifts
        with self._cache_lock:
            old = self._far_cache.get(node)
            if old is not None:
                self._far_cache_bytes -= old.nbytes
            self._far_cache[node] = far
            self._far_cache_bytes += far.nbytes
            while (self._far_cache_bytes > _FAR_CACHE_BYTES
                   and len(self._far_cache) > 1):
                _, evicted = self._far_cache.popitem(last=False)
                self._far_cache_bytes -= evicted.nbytes

    def _prefill_far(self, nodes: np.ndarray) -> None:
        """Build the missing far lists on the C++ thread pool
        (gs_far_lists); the same lists as the per-root path."""
        with self._cache_lock:
            missing = [v for v in dict.fromkeys(int(x) for x in nodes)
                       if v not in self._far_cache]
        if not missing:
            return
        g = self.graph
        fars = far_lists_native(g.indptr, g.indices, g.num_nodes,
                                np.asarray(missing, dtype=np.int32),
                                self.n_walk_len, self.train_nodes)
        for node, far in zip(missing, fars):
            self._insert_far(node, far)

    def prewarm_async(self, nodes: np.ndarray, chunk: int = 2048) -> None:
        """Build far lists for ``nodes`` on a background daemon thread.

        Bit-identical to lazy building (closures use no RNG);
        ``sample_batch`` takes whatever is cached and builds the rest.  A
        no-op in uniform mode.  ``close()`` stops it."""
        if self.negative_mode != "exact" or self._prewarm_thread is not None:
            return
        nodes = np.asarray(nodes)

        def work():
            for lo in range(0, len(nodes), chunk):
                if self._prewarm_stop.is_set():
                    return
                self._prefill_far(nodes[lo:lo + chunk])

        self._prewarm_thread = threading.Thread(
            target=work, daemon=True, name="gs-pairs-prewarm")
        self._prewarm_thread.start()

    def close(self) -> None:
        """Stop the prewarm thread (idempotent)."""
        self._prewarm_stop.set()
        if self._prewarm_thread is not None:
            self._prewarm_thread.join(timeout=30)
            self._prewarm_thread = None

    def negatives(self, node: int, num_neg: int,
                  rng: np.random.RandomState) -> np.ndarray:
        """Exact negatives: train nodes outside the <= n_walk_len-hop
        neighbourhood, sampled without replacement (reference
        src/models.py:163-166)."""
        far = self._far_nodes(node)
        if num_neg < len(far):
            return rng.choice(far, size=num_neg, replace=False)
        return far

    def positives(self, node: int, rng: np.random.RandomState) -> list[int]:
        """Random-walk co-occurrences (reference src/models.py:169-186):
        n_walks walks of walk_len uniform steps; every step landing on a
        train node other than the start records a pair.  Duplicates
        kept."""
        g = self.graph
        if len(g.neighbors(node)) == 0:
            return []
        out = []
        for _ in range(self.n_walks):
            curr = node
            for _ in range(self.walk_len):
                neigh = g.neighbors(curr)
                if len(neigh) == 0:
                    break
                nxt = int(neigh[rng.randint(len(neigh))])
                if nxt != node and nxt in self.train_set:
                    out.append(nxt)
                curr = nxt
        return out

    # ---- batched padded samplers ----------------------------------------
    def _positives_padded(self, batch_nodes: np.ndarray,
                          rng: np.random.RandomState):
        """(pos [B, P] int64, mask [B, P] bool)."""
        b = len(batch_nodes)
        p_max = max(1, self.n_walks * self.walk_len)
        pos = np.zeros((b, p_max), np.int64)
        mask = np.zeros((b, p_max), bool)
        for i, v in enumerate(batch_nodes):
            plist = self.positives(int(v), rng)[:p_max]
            pos[i, :len(plist)] = plist
            mask[i, :len(plist)] = True
        return pos, mask

    def _negatives_padded(self, batch_nodes: np.ndarray, num_neg: int,
                          rng: np.random.RandomState):
        """(neg [B, M] int64, mask [B, M] bool).  Uniform mode draws the
        whole batch in the C++ rejection sampler (gs_uniform_negatives),
        seeded from ``rng``; exact mode samples each cached far list."""
        b = len(batch_nodes)
        m_max = max(1, num_neg)
        neg = np.zeros((b, m_max), np.int64)
        mask = np.zeros((b, m_max), bool)
        if self.negative_mode == "uniform":
            if num_neg < 1:
                return neg, mask
            g = self.graph
            neg32, valid = uniform_negatives_native(
                g.indptr, g.indices, g.num_nodes, self.train_nodes,
                np.asarray(batch_nodes, dtype=np.int32), m_max,
                seed=int(rng.randint(2**31)))
            return neg32.astype(np.int64), valid
        for i, v in enumerate(batch_nodes):
            nlist = self.negatives(int(v), num_neg, rng)[:m_max]
            neg[i, :len(nlist)] = nlist
            mask[i, :len(nlist)] = True
        return neg, mask

    # ---- batch extension (reference src/models.py:135-148) -------------
    def sample_batch(self, batch_nodes: np.ndarray, num_neg: int,
                     rng: np.random.RandomState) -> PairBatch:
        batch_nodes = np.asarray(batch_nodes, dtype=np.int64)
        b = len(batch_nodes)
        if self.negative_mode == "exact":
            self._prefill_far(batch_nodes)  # batched C++ closure build
        pos, pos_maskb = self._positives_padded(batch_nodes, rng)
        neg, neg_maskb = self._negatives_padded(batch_nodes, num_neg, rng)

        # extended batch = union of endpoints in FIRST-SEEN order over
        # [batch, positives row-major, negatives row-major]; targets are
        # always included so target_rows is defined.  Vectorised:
        # np.unique plus the rank of each first occurrence.
        pos_flat = pos[pos_maskb]
        neg_flat = neg[neg_maskb]
        all_ids = np.concatenate([batch_nodes, pos_flat, neg_flat])
        uniq_sorted, first_idx, inverse = np.unique(
            all_ids, return_index=True, return_inverse=True)
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty(len(uniq_sorted), np.int64)
        rank[order] = np.arange(len(uniq_sorted))
        rows_all = rank[inverse]
        n_unique = len(uniq_sorted)

        u_pad = _bucket(n_unique)
        unique_arr = np.zeros(u_pad, dtype=np.int32)
        unique_arr[:n_unique] = uniq_sorted[order]

        target_rows = rows_all[:b].astype(np.int32)
        p_max, m_max = pos.shape[1], neg.shape[1]
        pos_q = np.zeros((b, p_max), np.int32)
        pos_q[pos_maskb] = rows_all[b:b + len(pos_flat)]
        neg_q = np.zeros((b, m_max), np.int32)
        neg_q[neg_maskb] = rows_all[b + len(pos_flat):]
        # the loss skips nodes lacking either side (src/models.py:75-76)
        node_valid = (pos_maskb.any(axis=1)
                      & neg_maskb.any(axis=1)).astype(np.float32)

        return PairBatch(
            unique_nodes=unique_arr, num_unique=n_unique,
            target_rows=target_rows,
            pos_q=pos_q,
            pos_mask=pos_maskb.astype(np.float32),
            neg_q=neg_q,
            neg_mask=neg_maskb.astype(np.float32),
            node_valid=node_valid,
        )
