"""Deterministic full-graph inference and serving bundles, on the card.

Port of ``graphsage_tpu/infer.py``.  Every node is propagated one layer at a
time over the full padded adjacency (all true neighbours, no sampling), so
two calls give bit-identical embeddings.  MEAN layers use the pretransform
(transform the [N, D] table once by the layer weight, then average H-wide
rows); MAX and LSTM layers aggregate the raw table, then transform; a POOL
layer puts the whole table through its pool MLP once (on the card one
``pretransform`` launch with the bias-and-relu epilogue), takes the max over
the P-wide pooled rows, then transforms.  A
cached-LSTM-hybrid model (``lstm_hybrid=True``) aggregates layer 1 with
MEAN and the layers above with their LSTM cells, the topology it was
trained with.

On the card a MEAN or MAX layer's aggregation is ONE launch of the
hand-written kernel (``graphsage_torch/csrc/aggregate.cu``) over all rows:
the kernel never builds the [block, S, D] gather that the JAX package
bounds with ``lax.map`` blocking.  An LSTM layer does build its [block, S,
D] slot sequence (one ``gather_rows`` launch a block, then the cell over
the block's rows), so it runs in row blocks under the byte budget of
``_pick_block`` at the layer's input width (:func:`card_block`).  On the
CPU the plain versions run block by block under the same budget, with the
JAX package's one block size for every layer.

Entry points run on the card unless the caller passes ``device="cpu"``; with
no card and no device given they raise.

Self-inclusion semantics match the samplers (reference src/models.py:285,
297-298): the aggregation set is the neighbour set minus the node itself
unless ``gcn``, in which case it is neighbours plus self, with self-loop
edges masked so that self is never counted twice.  MEAN over zero valid
slots gives 0.

Bundles are a directory with ``bundle.json`` (``format_version`` 1, the same
record as the JAX package writes) and ``params.npz``, one array per pytree
path.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from graphsage_torch.convert import (flatten_params, params_from_jax,
                                     params_to_numpy, unflatten_params)
from graphsage_torch.data.graph import PaddedAdjacency
from graphsage_torch.models.graphsage import (GraphSageConfig, compute_dtype,
                                              refuse_pool)
from graphsage_torch.models.layers import (classifier_apply,
                                           mean_pretransform, pool_transform,
                                           sage_layer_apply)
from graphsage_torch.models.lstm_agg import lstm_aggregate
from graphsage_torch.ops.aggregate import max_aggregate, mean_aggregate
from graphsage_torch.parallel.comm import all_gather_no_grad, rank_world
from graphsage_torch.utils.obs import span

# Working-set budget for one block's [block, S, gather_dim] gather: the
# plain versions' on the CPU, and the LSTM layers' on the card.
_GATHER_BYTES_BUDGET = 256 << 20


def _resolve_device(device: str | torch.device | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: graphsage_torch serves on the card; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _pick_block(n: int, width: int, gather_dim: int, itemsize: int,
                requested: int | None) -> int:
    """``gather_dim`` is the width of the rows actually gathered: out_size
    for MEAN (the pretransform gathers H-wide activations, never raw
    features), the raw feature dim for MAX layer 1."""
    if requested is not None:
        return max(1, min(requested, n))
    per_row = max(1, width * gather_dim * itemsize)
    block = _GATHER_BYTES_BUDGET // per_row
    # no lower clamp beyond 1: a wide uncapped adjacency (power-law hubs)
    # must be allowed tiny blocks
    return int(np.clip(block, 1, max(1, n)))


def card_block(agg_func: str, n: int, slots: int, width: int,
               itemsize: int, requested: int | None = None) -> int:
    """Rows a block of one layer on the card: all ``n`` for MEAN, MAX and
    POOL (one kernel launch), and for LSTM the ``_pick_block`` budget over the
    layer's [block, slots, width] slot sequence (or ``requested``)."""
    if agg_func != "LSTM":
        return max(n, 1)
    return _pick_block(n, slots, width, itemsize, requested)


def _cat_rows(parts: list[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _layer_full(cfg: GraphSageConfig, params: dict, layer: int,
                h: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                block: int, agg_func: str,
                self_h: torch.Tensor | None = None) -> torch.Tensor:
    """One full-table layer aggregated with ``agg_func``: [N, H] for the N
    rows of idx/mask, [N, S] aggregation slots into h's rows (self slot
    prepended by the caller in gcn mode).  The rows' own inputs are h
    (``self_h`` for MAX and LSTM when they are not h's first N rows: a
    shard's).  The aggregation runs over row blocks of ``block`` rows; on
    the card the caller passes :func:`card_block`'s.  Spans: one
    ``serve.transform`` and one ``serve.aggregate`` a block (on the card a
    layer, but LSTM's); MEAN's pretransform, one GEMM over every row, is
    timed on the device too, as are POOL's ``serve.pool`` (the pool MLP
    over every row of h, before the blocks) and its ``serve.transform`` (the
    sage layer after the max; POOL's pass is device-bound, where MAX's and
    LSTM's events would time a stream waiting on the host)."""
    w = params["layers"][layer]["weight"]
    hdim = w.shape[0]
    n = idx.shape[0]
    self_h = h if self_h is None else self_h
    rows = [slice(r0, min(r0 + block, n)) for r0 in range(0, n, block)]

    if agg_func == "MEAN":
        with span("serve.transform", device=h.device, layer=layer):
            # [N, H] with gcn, else [N, 2H]
            z = mean_pretransform(w, h, gcn=cfg.gcn)
        with span("serve.aggregate", layer=layer, rows=n):
            if cfg.gcn:
                out = [torch.relu(mean_aggregate(z, idx[r], mask[r]))
                       for r in rows]
            else:
                # z[:, H:] is a strided view; the kernel takes its row
                # stride
                out = [torch.relu(mean_aggregate(z[:, hdim:], idx[r],
                                                 mask[r]) + z[r, :hdim])
                       for r in rows]
            return _cat_rows(out)

    if agg_func in ("MAX", "LSTM", "POOL"):
        table = h
        if agg_func == "POOL":
            with span("serve.pool", device=h.device, layer=layer,
                      rows=h.shape[0]):
                table = pool_transform(params["pool"][layer], h)   # [N, P]
        out = []
        for r in rows:
            with span("serve.aggregate", layer=layer, rows=r.stop - r.start):
                if agg_func in ("MAX", "POOL"):
                    agg = max_aggregate(table, idx[r], mask[r])
                else:
                    agg = lstm_aggregate(params["agg"][layer], h, idx[r],
                                         mask[r])
            with span("serve.transform", layer=layer,
                      device=h.device if agg_func == "POOL" else None):
                self_rows = agg if cfg.gcn else self_h[r]
                out.append(sage_layer_apply(params["layers"][layer],
                                            self_rows, agg, gcn=cfg.gcn))
        return _cat_rows(out)

    raise ValueError(f"unknown agg_func {agg_func!r}")


def _slot_table(neighbors: torch.Tensor, degrees: torch.Tensor,
                gcn: bool, first: int = 0) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The aggregation slots of every node: idx [N, S] int32 and mask
    [N, S] float32, both contiguous (S = P, or P + 1 with gcn's self slot
    first).  ``first``: the node id of row 0 (a shard's rows)."""
    n, p = neighbors.shape
    dev = neighbors.device
    own = torch.arange(first, first + n, dtype=torch.int32, device=dev)
    slot = torch.arange(p, dtype=torch.int32, device=dev)
    valid = slot[None, :] < degrees[:, None]
    # self never aggregates with itself: the reference removes self from
    # the set unless gcn (src/models.py:297-298), and in gcn mode self
    # enters once via the dedicated slot below; mask self-loop edges
    # either way
    valid &= neighbors != own[:, None]
    mask = valid.float()
    idx = neighbors.to(torch.int32)
    if gcn:
        idx = torch.cat([own[:, None], idx], dim=1)
        mask = torch.cat([torch.ones((n, 1), device=dev), mask], dim=1)
    return idx.contiguous(), mask.contiguous()


def _full_embed(params: dict, cfg: GraphSageConfig, feats: torch.Tensor,
                neighbors: torch.Tensor, degrees: torch.Tensor,
                block: int | None, lstm_hybrid: bool) -> torch.Tensor:
    """All-layer full-neighbourhood propagation: [N, D] -> [N, out_size].
    On the CPU ``block`` rows a block for every layer; on the card each
    layer takes :func:`card_block`'s, with ``block`` as the request.  With
    ``lstm_hybrid`` layer 1 aggregates with MEAN: a hybrid model's layer-0
    cell is never trained and must not be used."""
    idx, mask = _slot_table(neighbors, degrees, cfg.gcn)
    h = feats.to(compute_dtype(cfg))
    n = h.shape[0]
    for layer in range(cfg.num_layers):
        agg_func = "MEAN" if lstm_hybrid and layer == 0 else cfg.agg_func
        rows = block
        if h.is_cuda:
            rows = card_block(agg_func, n, idx.shape[1], h.shape[1],
                              h.element_size(), block)
        h = _layer_full(cfg, params, layer, h, idx, mask, rows, agg_func)
    return h


def full_graph_embeddings(params: dict, cfg: GraphSageConfig,
                          feats, pad: PaddedAdjacency,
                          block: int | None = None,
                          fetch: bool = True,
                          lstm_hybrid: bool = False,
                          device: str | torch.device | None = None):
    """Exact deterministic embeddings for every node: [N, out_size] f32.

    ``params`` is the encoder pytree ({"layers": [{"weight"}]}, with LSTM
    also {"agg": [cell, ...]}) of tensors or numpy arrays.  ``pad`` should
    be the full (uncapped) adjacency for exact semantics; a width-capped
    table computes the same propagation over the capped neighbour sets.
    ``feats`` and ``pad``'s tables may be numpy arrays or tensors; pass
    tensors already on ``device`` to avoid an upload per call
    (``InferenceSession`` does).  ``block`` bounds the plain versions'
    gather on the CPU; on the card MEAN and MAX layers are one launch over
    all rows, and ``block`` (by default the byte budget) sets the rows of an
    LSTM layer's blocks.  ``fetch=False`` returns the on-device [N,
    out_size] tensor in the compute dtype instead of a host float32 array.
    ``lstm_hybrid=True`` serves a cached-LSTM-hybrid model
    (``CachedTrainer(lstm_hybrid=True)``): MEAN at layer 1, the live LSTM
    cells above.
    """
    dev = _resolve_device(device)
    params = params_from_jax(params, dev)
    feats = _as_tensor(feats, dev)
    n = pad.num_nodes
    if dev.type != "cuda":
        gather_dim = (cfg.out_size if cfg.agg_func == "MEAN"
                      else cfg.pool_size if cfg.agg_func == "POOL"
                      else max(int(feats.shape[1]), cfg.out_size))
        block = _pick_block(n, pad.width, gather_dim,
                            compute_dtype(cfg).itemsize, block)
    with torch.no_grad():
        out = _full_embed(params, cfg, feats, _as_tensor(pad.neighbors, dev),
                          _as_tensor(pad.degrees, dev), block, lstm_hybrid)
    if not fetch:
        return out
    return out.float().cpu().numpy()


def full_graph_embeddings_sharded(params: dict, cfg: GraphSageConfig,
                                  feats, pad: PaddedAdjacency,
                                  group=None, lstm_hybrid: bool = False,
                                  device: str | torch.device | None = None,
                                  fetch: bool = True):
    """Deterministic inference with the node rows sharded over the ranks of
    a ``torch.distributed`` group (``graphsage_tpu/infer.py:210``); every
    rank of the group calls it.

    Per layer each rank transforms its OWN N/P rows, ``all_gather_rows``
    the [N, ·] table and aggregates its own rows' neighbourhoods: for MEAN
    through the pretransform, so the collective moves H-wide rows; MAX and
    LSTM are nonlinear in the neighbours and gather the raw [N, Din] table.
    The aggregations are the ``gather_mean`` / ``gather_max`` kernels on the
    card, one launch a layer (LSTM in ``card_block`` row blocks).  The
    same math as :func:`full_graph_embeddings` up to reassociation: on one
    rank the same operations on the same tables.  ``lstm_hybrid`` runs
    layer 1 with MEAN, as there.

    Returns the whole [N, out_size] table on every rank (a last all_gather),
    float32 numpy, or with ``fetch=False`` the on-device tensor in the
    compute dtype.  POOL is refused (``models.graphsage.refuse_pool``)."""
    refuse_pool(cfg, "full_graph_embeddings_sharded")
    dev = _resolve_device(device)
    rank, world = rank_world(group)
    params = params_from_jax(params, dev)
    n = pad.num_nodes
    rows_per = -(-n // world)
    lo, hi = rank * rows_per, min((rank + 1) * rows_per, n)
    with torch.no_grad():
        idx, mask = _slot_table(_as_tensor(pad.neighbors, dev)[lo:hi],
                                _as_tensor(pad.degrees, dev)[lo:hi],
                                cfg.gcn, first=lo)
        h = torch.zeros((rows_per, feats.shape[1]), dtype=compute_dtype(cfg),
                        device=dev)
        h[:hi - lo] = _as_tensor(feats, dev)[lo:hi].to(h.dtype)
        # rows past N (the last rank's padding) aggregate nothing
        pad_rows = rows_per - (hi - lo)
        idx = torch.cat([idx, idx.new_zeros((pad_rows, idx.shape[1]))])
        mask = torch.cat([mask, mask.new_zeros((pad_rows, mask.shape[1]))])
        for layer in range(cfg.num_layers):
            agg_func = "MEAN" if lstm_hybrid and layer == 0 else cfg.agg_func
            w = params["layers"][layer]["weight"]
            hdim = w.shape[0]
            if agg_func == "MEAN":
                z_loc = mean_pretransform(w, h, gcn=cfg.gcn)
                z = all_gather_no_grad(z_loc, group)
                if cfg.gcn:
                    h = torch.relu(mean_aggregate(z, idx, mask))
                else:
                    h = torch.relu(mean_aggregate(z[:, hdim:], idx, mask)
                                   + z_loc[:, :hdim])
                continue
            block = rows_per
            if h.is_cuda:
                block = card_block(agg_func, rows_per, idx.shape[1],
                                   h.shape[1], h.element_size())
            h = _layer_full(cfg, params, layer, all_gather_no_grad(h, group),
                            idx, mask, block, agg_func, self_h=h)
        out = all_gather_no_grad(h, group)[:n]
    if not fetch:
        return out
    return out.float().cpu().numpy()


# --------------------------------------------------------------- serving

_BUNDLE_META = "bundle.json"
_BUNDLE_PARAMS = "params.npz"


def _expected_shapes(mcfg: GraphSageConfig, num_classes: int) -> dict:
    shapes = {"clf/weight": (num_classes, mcfg.out_size),
              "clf/bias": (num_classes,)}
    for i in range(mcfg.num_layers):
        d = mcfg.layer_input_size(i)
        shapes[f"sage/layers/{i}/weight"] = (mcfg.out_size,
                                             mcfg.sage_input_size(i))
        if mcfg.agg_func == "POOL":
            shapes.update({f"sage/pool/{i}/weight": (mcfg.pool_size, d),
                           f"sage/pool/{i}/bias": (mcfg.pool_size,)})
        if mcfg.agg_func == "LSTM":
            shapes.update({f"sage/agg/{i}/w_ih": (4 * d, d),
                           f"sage/agg/{i}/w_hh": (4 * d, d),
                           f"sage/agg/{i}/b_ih": (4 * d,),
                           f"sage/agg/{i}/b_hh": (4 * d,)})
    return shapes


def export_bundle(path: str, params: dict, mcfg: GraphSageConfig,
                  num_classes: int, meta: dict | None = None) -> None:
    """Write a self-contained serving bundle: ``bundle.json`` + params.

    ``params`` is the pytree {"sage": ..., "clf": ...} of tensors or numpy
    arrays; they are stored as float32 numpy arrays keyed by pytree path.
    ``pool_size`` is recorded for POOL alone, so that every other model's
    ``bundle.json`` is the JAX package's record."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    model = dataclasses.asdict(mcfg)
    if mcfg.agg_func != "POOL":
        del model["pool_size"]
    record = {
        "model": model,
        "num_classes": int(num_classes),
        "format_version": 1,
    }
    if meta:
        record["meta"] = meta
    with open(os.path.join(path, _BUNDLE_META), "w") as f:
        json.dump(record, f, indent=1)
    np.savez(os.path.join(path, _BUNDLE_PARAMS),
             **flatten_params(params_to_numpy(params)))


def load_bundle(path: str) -> tuple[dict, GraphSageConfig, int, dict]:
    """Restore (params, mcfg, num_classes, meta) from an exported bundle;
    params come back as numpy arrays."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _BUNDLE_META)) as f:
        record = json.load(f)
    version = record.get("format_version")
    if version != 1:
        raise ValueError(
            f"bundle at {path} has format_version={version!r}; this "
            f"build reads version 1 — re-export the bundle or upgrade")
    mcfg = GraphSageConfig(**record["model"])
    num_classes = int(record["num_classes"])
    with np.load(os.path.join(path, _BUNDLE_PARAMS)) as npz:
        flat = {k: npz[k] for k in npz.files}
    got = {k: v.shape for k, v in flat.items()}
    want = _expected_shapes(mcfg, num_classes)
    if got != want:
        raise ValueError(f"bundle at {path} holds params {got}, but its "
                         f"config needs {want}")
    return (unflatten_params(flat), mcfg, num_classes,
            record.get("meta", {}))


class InferenceSession:
    """Serving-side handle: deterministic embeddings + class predictions.

    Wraps a trained (or bundle-loaded) model with a graph: pins the params,
    features and adjacency on the device once, computes the full-graph
    embedding table once (lazily) and serves node queries from it.
    """

    def __init__(self, params: dict, mcfg: GraphSageConfig,
                 feats, pad: PaddedAdjacency,
                 block: int | None = None,
                 lstm_hybrid: bool = False,
                 device: str | torch.device | None = None) -> None:
        self.device = _resolve_device(device)
        self.params = params_from_jax(params, self.device)
        self.mcfg = mcfg
        self.lstm_hybrid = lstm_hybrid
        self.feats = _as_tensor(feats, self.device)
        self.pad = PaddedAdjacency(
            neighbors=_as_tensor(pad.neighbors, self.device),
            degrees=_as_tensor(pad.degrees, self.device),
            true_degrees=pad.true_degrees, truncated=pad.truncated)
        self.block = block
        self._emb: torch.Tensor | None = None       # [N, H] f32, on device
        self._emb_host: np.ndarray | None = None

    @classmethod
    def from_bundle(cls, path: str, feats, pad: PaddedAdjacency,
                    block: int | None = None,
                    device: str | torch.device | None = None
                    ) -> "InferenceSession":
        params, mcfg, _ncls, meta = load_bundle(path)
        return cls(params, mcfg, feats, pad, block,
                   lstm_hybrid=bool(meta.get("lstm_hybrid", False)),
                   device=device)

    def _table(self) -> torch.Tensor:
        if self._emb is None:
            self._emb = full_graph_embeddings(
                self.params["sage"], self.mcfg, self.feats, self.pad,
                self.block, fetch=False, lstm_hybrid=self.lstm_hybrid,
                device=self.device).float()
        return self._emb

    def embeddings(self) -> np.ndarray:
        """[N, out_size] f32 table, computed once and cached."""
        if self._emb_host is None:
            self._emb_host = self._table().cpu().numpy()
        return self._emb_host

    def embed(self, nodes) -> np.ndarray:
        """Rows of the embedding table; a scalar id yields a [1, H] batch
        (predict/log_probs always return batched results)."""
        return self.embeddings()[np.atleast_1d(np.asarray(nodes))]

    def log_probs(self, nodes) -> np.ndarray:
        ids = torch.as_tensor(np.atleast_1d(np.asarray(nodes)),
                              device=self.device)
        with torch.no_grad():
            lp = classifier_apply(self.params["clf"], self._table()[ids])
        return lp.float().cpu().numpy()

    def predict(self, nodes) -> np.ndarray:
        """argmax class per node (reference predicts via
        classification(embs).max(1), src/utils.py:28-33)."""
        return np.argmax(self.log_probs(nodes), axis=1)

    def score_pairs(self, src, dst) -> np.ndarray:
        """Cosine similarity between embedding pairs (the unsup objective's
        score, reference src/models.py:82).  src/dst: equal-length node-id
        arrays; returns [len] f32 in [-1, 1]."""
        emb = self.embeddings()
        a = emb[np.atleast_1d(np.asarray(src))]
        b = emb[np.atleast_1d(np.asarray(dst))]
        denom = (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        return (a * b).sum(axis=1) / np.maximum(denom, 1e-12)


def _main(argv=None) -> int:
    """Serving CLI: load a bundle, embed/predict from the command line.

    python -m graphsage_torch.infer --bundle bundles/cora --dataSet cora \
        [--nodes 0,1,2] [--eval] [--save_embeddings out.npy] [--device cuda]
    """
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--dataSet", default="cora")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--seed", type=int, default=824,
                    help="dataset seed (split / synthetic generation) — "
                         "must match the training run's")
    ap.add_argument("--nodes", default=None,
                    help="comma-separated node ids to predict")
    ap.add_argument("--eval", action="store_true",
                    help="report deterministic val/test micro-F1")
    ap.add_argument("--save_embeddings", default=None,
                    help="write the [N, H] f32 table as .npy")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from graphsage_torch.data import load_dataset

    kw = {"root": args.data_root} if args.data_root else {}
    ds = load_dataset(args.dataSet, seed=args.seed, **kw)
    sess = InferenceSession.from_bundle(args.bundle, ds.features,
                                        ds.graph.to_padded(),
                                        device=args.device)
    if args.nodes:
        ids = np.array([int(x) for x in args.nodes.split(",")])
        for i, p in zip(ids, sess.predict(ids)):
            print(f"node {i}: class {p}")
    if args.eval:
        from graphsage_torch.train.metrics import micro_f1
        for split, nodes in (("val", ds.val_nodes),
                             ("test", ds.test_nodes)):
            f1 = micro_f1(ds.labels[nodes], sess.predict(nodes))
            print(f"{split} micro-F1: {f1:.4f}")
    if args.save_embeddings:
        np.save(args.save_embeddings, sess.embeddings())
        print(f"wrote embeddings {sess.embeddings().shape} to "
              f"{args.save_embeddings}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
