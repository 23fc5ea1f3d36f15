"""GraphSAGE configuration, parameter init and the sampled encoder.

Port of ``graphsage_tpu/models/graphsage.py``.  ``GraphSageConfig`` keeps
the JAX package's fields and defaults, so a serving ``bundle.json`` means the
same model to both packages.

The sampled computation graph is a list of ``Frontier``s, fixed-shape index
tables built by the host samplers (``graphsage_torch.sampler``), one per
layer, bottom-up:

  idx      [U_l, S] int32: slots index rows of the previous layer's
           embedding matrix (layer 0: the gathered raw features);
  mask     [U_l, S] float32: 1 for slots that take part in the aggregation
           (the reference's sample-then-remove-self rule, take-all below the
           fanout, and row padding; src/models.py:282-298);
  self_idx [U_l] int32: the row of the previous matrix holding the node's
           own features (src/models.py:271-275).

Rows past the real union size are padding: idx/self_idx 0, mask 0.

The encoder trains MEAN, MAX, LSTM and POOL GraphSAGE, in float32 or, given
bfloat16 tables and params that the trainers round to bfloat16
(``train.dense.cast_compute``), in bfloat16.  A MEAN layer
aggregates with ``ops.aggregate.mean_aggregate`` (the ``gather_mean`` kernel
on the card, with its scatter-add backward), a MAX layer with
``max_aggregate`` (``gather_max``, with the tie-splitting backward), an LSTM
layer with ``models.lstm_agg.lstm_aggregate`` (the ``gather_rows`` kernel,
then the cell), whatever ``impl`` says; ``impl`` still decides the layer
structure, as in the JAX package.  The pretransform applies to MEAN only.

POOL is GraphSAGE-pool (Hamilton et al. 2017, Eq. 3), which the JAX package
does not have: each layer first puts every row of the previous layer's
matrix through its pool MLP once, z = relu(h W_pool^T + b) (the frontier's
unique source rows, not each sampled slot: the authors' code applies the
MLP to every slot), then ``max_aggregate`` over the slots of z, then the
sage layer relu(W [self || max]) with W [H, D + P].  Its parameters are
``{"layers": [{"weight"}], "pool": [{"weight", "bias"}]}``; the compact
pipeline and full-graph serving run it, and the cached, dense and
distributed pipelines and sharded serving refuse it
(:func:`refuse_pool`): their leaf caches and exchanges hold raw-feature
aggregates, which a trained pool MLP makes meaningless.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from graphsage_torch.models.layers import (init_pool, mean_pretransform,
                                           pool_transform, sage_layer_apply,
                                           xavier_uniform)
from graphsage_torch.models.lstm_agg import init_lstm_agg, lstm_aggregate
from graphsage_torch.ops.aggregate import max_aggregate, mean_aggregate
from graphsage_torch.ops.scatter import take_rows
from graphsage_torch.utils.obs import span


@dataclasses.dataclass(frozen=True)
class Frontier:
    idx: Any        # [U, S] int32
    mask: Any       # [U, S] float32
    self_idx: Any   # [U] int32


@dataclasses.dataclass(frozen=True)
class GraphSageConfig:
    num_layers: int = 2          # reference src/experiments.conf:11
    input_size: int = 1433
    out_size: int = 128          # reference src/experiments.conf:12
    gcn: bool = False
    agg_func: str = "MEAN"       # MEAN | MAX | LSTM | POOL
    # The JAX package's switch between its XLA ops and its Pallas kernels.
    # Kept so that bundles read the same; the port's aggregations on the
    # card always run its CUDA kernels.
    impl: str = "xla"            # xla | pallas
    # Params stay float32; activations and the aggregated tables are kept
    # in this dtype, with float32 accumulation.
    compute_dtype: str = "float32"    # float32 | bfloat16
    # MEAN-layer restructuring (transform the table, then average H-wide
    # rows) for the sampled encoder; full-graph serving always applies it.
    mean_pretransform: str = "auto"   # auto | never | always
    # POOL's hidden width, the pool MLP's output: 512 for the authors'
    # model_size "small", 1024 for "big" (graphsage/aggregators.py).  A
    # bundle records it for POOL only (``infer.export_bundle``).
    pool_size: int = 512

    def layer_input_size(self, layer: int) -> int:
        """Layer 1 consumes raw features, deeper layers consume out_size
        (reference src/models.py:237-239)."""
        return self.input_size if layer == 0 else self.out_size

    def sage_input_size(self, layer: int) -> int:
        """The width of the sage weight's input, [self || aggregate]: twice
        the layer's input (the aggregate alone with gcn), or for POOL the
        input and the pooled row's ``pool_size``."""
        agg = (self.pool_size if self.agg_func == "POOL"
               else self.layer_input_size(layer))
        return agg if self.gcn else self.layer_input_size(layer) + agg


def compute_dtype(cfg: GraphSageConfig) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one "
                         f"of {sorted(dtypes)}")
    return dtypes[cfg.compute_dtype]


def init_graphsage(generator: torch.Generator, cfg: GraphSageConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    """{"layers": [{"weight": [out_size, in_total]}, ...]} with xavier
    weights, and for LSTM {"agg": [cell, ...]}, one ``init_lstm_agg`` cell a
    layer with hidden size equal to the layer's input size, all drawn from
    ``generator`` layer by layer: the layer's weight, then its cell (the
    JAX package's key order, ``graphsage_tpu/models/graphsage.py:78-92``).
    POOL draws the layer's weight [out_size, in + pool_size], then its pool
    MLP (``init_pool``) into {"pool": [{"weight", "bias"}, ...]}."""
    params: dict = {"layers": [], "agg": [], "pool": []}
    for i in range(cfg.num_layers):
        in_size = cfg.layer_input_size(i)
        params["layers"].append({"weight": xavier_uniform(
            generator, (cfg.out_size, cfg.sage_input_size(i)), dtype)})
        if cfg.agg_func == "LSTM":
            params["agg"].append(init_lstm_agg(generator, in_size, dtype))
        if cfg.agg_func == "POOL":
            params["pool"].append(init_pool(generator, in_size,
                                            cfg.pool_size, dtype))
    for key in ("agg", "pool"):
        if not params[key]:
            del params[key]
    return params


def _check_trainable(cfg: GraphSageConfig) -> None:
    if cfg.agg_func not in ("MEAN", "MAX", "LSTM", "POOL"):
        raise ValueError(f"unknown agg_func {cfg.agg_func!r}")


def refuse_pool(cfg: GraphSageConfig, where: str) -> None:
    """Raise for a POOL model on a path that does not run it (``where``
    names the path)."""
    if cfg.agg_func == "POOL":
        raise ValueError(
            f"agg_func POOL is not supported by {where}: it trains on the "
            "compact pipeline and serves through full_graph_embeddings; "
            "this path keeps raw-feature aggregates (a leaf cache or an "
            "exchange of raw rows), which a layer's trained pool MLP makes "
            "meaningless")


def _aggregate(cfg: GraphSageConfig, params: dict, layer: int,
               h: torch.Tensor, frontier: Frontier) -> torch.Tensor:
    """The layer's aggregation by ``agg_func``
    (``graphsage_tpu/models/graphsage.py:95-112``); LSTM takes the layer's
    cell, ``params["agg"][layer]``."""
    if cfg.agg_func == "MEAN":
        return mean_aggregate(h, frontier.idx, frontier.mask)
    if cfg.agg_func == "MAX":
        return max_aggregate(h, frontier.idx, frontier.mask)
    if cfg.agg_func == "LSTM":
        return lstm_aggregate(params["agg"][layer], h, frontier.idx,
                              frontier.mask)
    if cfg.agg_func == "POOL":
        # the MLP over each of the previous layer's rows once, then the max
        # over the slots of the pooled rows
        with span("step.pool", layer=layer, rows=h.shape[0]):
            z = pool_transform(params["pool"][layer], h)
        return max_aggregate(z, frontier.idx, frontier.mask)
    raise ValueError(f"unknown agg_func {cfg.agg_func!r}")


def graphsage_apply(params: dict, cfg: GraphSageConfig, x0: torch.Tensor,
                    frontiers: Sequence[Frontier],
                    join=None) -> torch.Tensor:
    """Bottom-up encode (reference src/models.py:255-269).

    x0: [U_0, D] raw-feature rows of the deepest union; frontiers[l] maps
    layer-l rows onto layer-(l-1) rows.  Returns [U_L, out_size] in the top
    frontier's row order.  ``join`` maps each layer's output but the last
    before the next layer takes it (see :func:`graphsage_apply_gathered`)."""
    _check_trainable(cfg)
    assert len(frontiers) == cfg.num_layers
    h = x0
    for layer, frontier in enumerate(frontiers):
        if layer and join is not None:
            h = join(h)
        h = _layer(cfg, params, layer, h, frontier)
    return h


def _layer(cfg: GraphSageConfig, params: dict, layer: int, h: torch.Tensor,
           frontier: Frontier) -> torch.Tensor:
    layer_params = params["layers"][layer]
    if _use_pretransform(cfg, h, frontier):
        return _mean_pretransform_layer(cfg, layer_params, h, frontier)
    agg = _aggregate(cfg, params, layer, h, frontier)
    self_feats = take_rows(h, frontier.self_idx)
    return sage_layer_apply(layer_params, self_feats, agg, gcn=cfg.gcn)


def graphsage_apply_gathered(params: dict, cfg: GraphSageConfig,
                             feats: torch.Tensor, x0_ids: torch.Tensor,
                             frontiers: Sequence[Frontier], join=None,
                             u0: int | None = None) -> torch.Tensor:
    """Like graphsage_apply, from the full feature table and the gather ids.

    When the table has no more than twice the rows of the expanded frontier
    (``n <= 2 * u0``, the JAX package's ``apply_table`` rule), layer 1
    transforms the TABLE once ([N, D] x [D, 2H]) and every gather moves
    H-wide rows instead of D-wide ones.

    On a rank of a tensor-parallel ``model`` axis (``train.dense`` with a
    mesh) the layer weights are the rank's rows, so each layer yields the
    rank's column slice of its output: ``join``
    (``parallel.comm.all_gather_cols``) makes it whole before the next
    layer, and the last layer's slice is returned.  ``u0`` is then the
    frontier's global row count, on which the rule decides as GSPMD does
    on global shapes (a data rank holds a block of the rows; the rule of
    the later layers compares two row counts of one block, whose ratio the
    block keeps)."""
    _check_trainable(cfg)
    f0 = frontiers[0]
    u0 = x0_ids.shape[0] if u0 is None else u0
    n = feats.shape[0]
    apply_table = (
        cfg.agg_func == "MEAN" and cfg.mean_pretransform != "never"
        and cfg.impl != "pallas"  # same rule as _use_pretransform
        and (cfg.mean_pretransform == "always" or n <= 2 * u0))
    if not apply_table:
        x0 = feats[x0_ids.long()]
        return graphsage_apply(params, cfg, x0, frontiers, join)

    w = params["layers"][0]["weight"]
    # compose index maps: frontier slots -> x0 rows -> table rows
    x0_ids = x0_ids.long()
    idx_t = x0_ids[f0.idx.long()].to(torch.int32)
    self_t = x0_ids[f0.self_idx.long()]
    if cfg.gcn:
        h_agg = mean_pretransform(w, feats, gcn=True)            # [N, H]
        h = torch.relu(mean_aggregate(h_agg, idx_t, f0.mask))
    else:
        # one [N, D] x [D, 2H] product; the aggregate reads the strided
        # AGG half h_cat[:, H:] in place
        h_cat = mean_pretransform(w, feats)                      # [N, 2H]
        hdim = w.shape[0]
        agg = mean_aggregate(h_cat[:, hdim:], idx_t, f0.mask)
        h = torch.relu(agg + take_rows(h_cat[:, :hdim], self_t))

    for layer in range(1, cfg.num_layers):
        if join is not None:
            h = join(h)
        h = _layer(cfg, params, layer, h, frontiers[layer])
    return h


def _use_pretransform(cfg: GraphSageConfig, h: torch.Tensor,
                      frontier: Frontier) -> bool:
    """The JAX package's rule (``graphsage.py:190-208``), verbatim."""
    if cfg.agg_func != "MEAN" or cfg.mean_pretransform == "never":
        return False
    # an explicit impl="pallas" keeps the aggregate-then-transform layers
    if cfg.impl == "pallas":
        return False
    if cfg.mean_pretransform == "always":
        return True
    m = h.shape[0]
    u = frontier.idx.shape[0]
    # FLOP-equal at m == u (non-gcn); the traffic win scales with D/H, so
    # allow extra transform FLOPs when the feature dim is wide
    d = h.shape[1]
    width_bonus = 2 if d >= 4 * cfg.out_size else 1
    return m <= 2 * u * width_bonus


def _mean_pretransform_layer(cfg: GraphSageConfig, layer_params: dict,
                             h: torch.Tensor,
                             frontier: Frontier) -> torch.Tensor:
    """relu(W [self || mean(neigh)]) as relu(mean((W_agg h)[neigh]) +
    (W_self h)[self]), exact by the linearity of the mean."""
    w = layer_params["weight"]                     # [H, 2D] (or [H, D] gcn)
    if cfg.gcn:
        h_agg = mean_pretransform(w, h, gcn=True)  # [M, H]
        return torch.relu(mean_aggregate(h_agg, frontier.idx, frontier.mask))
    h_cat = mean_pretransform(w, h)                # [M, 2H]
    hdim = w.shape[0]
    agg = mean_aggregate(h_cat[:, hdim:], frontier.idx, frontier.mask)
    return torch.relu(agg + take_rows(h_cat[:, :hdim], frontier.self_idx))
