"""Dense layers: SageLayer, the classification head and the encoder.

Port of ``graphsage_tpu/models/layers.py``.  The functions take parameters as
plain dicts of tensors, laid out as the JAX package's pytrees (weights
``[out, in]``), so ``graphsage_torch.convert.params_from_jax`` carries JAX
params over unchanged.  The ``nn.Module``s below hold the same parameters and
call the same functions.

Reference semantics:
- SageLayer (reference src/models.py:189-220): weight W in [out, 2*in] (or
  [out, in] in gcn mode), xavier-uniform init, **no bias**; forward is
  relu(concat([self, agg]) @ W.T).  A GraphSAGE-pool layer aggregates
  P-wide pooled rows, so its W is [out, in + P] ([out, P] with gcn), and
  its pool MLP (``init_pool``, ``pool_transform``) has a bias.
- Classification (reference src/models.py:8-27): Linear(emb -> classes) with
  bias, xavier-uniform on the weight, U(+-1/sqrt(fan_in)) on the bias, then
  log_softmax.

Products follow ``jnp.dot(..., preferred_element_type=float32)`` and round
once to the activation dtype.  Under bfloat16 compute both operands are
bfloat16 (the trainers round the float32 master weights with
``train.dense.cast_compute`` inside the loss), and the port upcasts them
to float32 and takes a float32 ``torch.matmul``: the products of bfloat16
numbers are exact in float32, so this is the same arithmetic with float32
accumulation.  MEAN's pretransform of a bfloat16 table, where autograd
would not record it, multiplies the table by the float32 weight split
exactly into three bfloat16 pieces (``ops.pretransform``), the same
float32 products in another order of sums, without the upcast.  The
classifier adds its bfloat16-rounded bias to the float32 logits, as JAX's
promotion does.  ``torch.backends.cuda.matmul.allow_tf32``
stays False (PyTorch's default) for float32 parity.

The bfloat16 products that stay bfloat16 (the LSTM cell's gate GEMMs, the
cached pipeline's upper-layer ``einsum``, forward and backward) are
``torch.matmul`` in bfloat16; on the card cuBLAS may then reduce in
bfloat16 (split-K) unless
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
False.  Importing this module (so any of ``graphsage_torch.models``) sets
it False, once, for the process: the sums then stay in float32 as JAX's
dots keep them on the TPU, for every bfloat16 GEMM of the port and its
autograd backward alike.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graphsage_torch.models.lstm_agg import LSTMAggregator
from graphsage_torch.ops.aggregate import max_aggregate, mean_aggregate
from graphsage_torch.ops.pretransform import pretransform
from graphsage_torch.utils import obs


torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def xavier_uniform(generator: torch.Generator, shape: tuple[int, int],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ semantics for a 2-D weight [out, in]:
    U(-a, a) with a = sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-a, a,
                                                    generator=generator)


def init_sage_layer(generator: torch.Generator, input_size: int,
                    out_size: int, gcn: bool = False,
                    dtype: torch.dtype = torch.float32) -> dict:
    in_total = input_size if gcn else 2 * input_size
    return {"weight": xavier_uniform(generator, (out_size, in_total), dtype)}


def init_pool(generator: torch.Generator, input_size: int, pool_size: int,
              dtype: torch.dtype = torch.float32) -> dict:
    """GraphSAGE-pool's per-neighbour MLP of one layer: a xavier-uniform
    weight [pool_size, input_size] and a zero bias [pool_size], the
    authors' ``Dense`` layer (``graphsage/layers.py``)."""
    return {"weight": xavier_uniform(generator, (pool_size, input_size),
                                     dtype),
            "bias": torch.zeros((pool_size,), dtype=dtype)}


def init_classifier(generator: torch.Generator, emb_size: int,
                    num_classes: int,
                    dtype: torch.dtype = torch.float32) -> dict:
    bound = 1.0 / math.sqrt(emb_size)
    weight = xavier_uniform(generator, (num_classes, emb_size), dtype)
    bias = torch.empty((num_classes,), dtype=dtype).uniform_(
        -bound, bound, generator=generator)
    return {"weight": weight, "bias": bias}


def mean_pretransform(w: torch.Tensor, h: torch.Tensor,
                      gcn: bool = False) -> torch.Tensor:
    """Transform-first half of the MEAN pretransform: z = h @ W_part.T.

    The mean is linear, so relu(W @ [self || mean(neigh)]) equals
    relu(mean(z_agg[neigh]) + z_self[self]) with the table transformed
    once.  Returns [N, H] for gcn, else [N, 2H] with the SELF columns in
    ``[:, :H]`` and the AGG columns in ``[:, H:]`` (the convention of
    ``graphsage_tpu/models/layers.py:40-59``).  ``w`` is the sage layer's
    [H, 2D] (or [H, D] gcn) weight.

    A bfloat16 table in a call that autograd would not record (serving,
    evaluation) takes ``ops.pretransform.pretransform``: the float32 weight
    split exactly into three bfloat16 pieces, their products summed in
    float32 (the tensor-core kernel on the card, the plain version on the
    CPU).  Every other call, a float32 table or a differentiated one, takes
    the float32 ``torch.matmul`` below."""
    if h.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)):
        if not gcn:
            d = h.shape[1]
            w = torch.cat([w[:, :d], w[:, d:]], dim=0)      # [2H, D]
        return pretransform(h, w)
    w = w.float()
    if not gcn:
        d = h.shape[1]
        w = torch.cat([w[:, :d], w[:, d:]], dim=0)  # [2H, D]
    return torch.matmul(h.float(), w.T).to(h.dtype)


def pool_transform(params: dict, h: torch.Tensor) -> torch.Tensor:
    """GraphSAGE-pool's per-neighbour MLP over every row of ``h`` [M, D]:
    relu(h @ W_pool.T + b) -> [M, P] in h's dtype, the products summed in
    float32 and rounded once (Hamilton et al. 2017, Eq. 3).  Applied to
    each source row once; the max over a node's slots then reads its rows.

    A bfloat16 table in a call that autograd would not record (serving,
    evaluation) takes ``ops.pretransform.pretransform`` with its
    bias-and-relu epilogue: the float32 weight split exactly into three
    bfloat16 pieces, one kernel launch on the card.  Every other call, a
    float32 table or a differentiated one, takes the float32
    ``torch.matmul`` and adds the bias (the trainers' bfloat16-rounded one
    under bfloat16 compute) to the float32 sums."""
    w, b = params["weight"], params["bias"]
    obs.count("pool.transform_rows", h.shape[0])
    if h.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled()
            and (h.requires_grad or w.requires_grad or b.requires_grad)):
        return pretransform(h, w, bias=b)
    z = torch.matmul(h.float(), w.float().T) + b.float()
    return torch.relu(z).to(h.dtype)


def sage_layer_apply(params: dict, self_feats: torch.Tensor,
                     agg_feats: torch.Tensor,
                     gcn: bool = False) -> torch.Tensor:
    """relu(concat([self || agg]) @ W.T); gcn mode drops the concat
    (reference src/models.py:209-220)."""
    if gcn:
        combined = agg_feats
    else:
        combined = torch.cat([self_feats, agg_feats], dim=-1)
    out = torch.matmul(combined.float(), params["weight"].float().T)
    return torch.relu(out).to(combined.dtype)


def classifier_apply(params: dict, embeds: torch.Tensor,
                     partial_sum=None) -> torch.Tensor:
    """log_softmax(Linear(embeds)), reference src/models.py:25-27.

    On a rank of a tensor-parallel ``model`` axis ``embeds`` and the weight
    are the rank's column slices, and ``partial_sum``
    (``parallel.comm.sum_partials``) sums the partial logits over the model
    group before the bias is added, once."""
    logits = torch.matmul(embeds.float(), params["weight"].float().T)
    if partial_sum is not None:
        logits = partial_sum(logits)
    logits = logits + params["bias"].float()
    return torch.log_softmax(logits, dim=-1).to(embeds.dtype)


class SageLayer(nn.Module):
    def __init__(self, input_size: int, out_size: int, gcn: bool = False, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.gcn = gcn
        self.weight = nn.Parameter(init_sage_layer(
            generator, input_size, out_size, gcn, dtype)["weight"])

    def forward(self, self_feats: torch.Tensor,
                agg_feats: torch.Tensor) -> torch.Tensor:
        return sage_layer_apply({"weight": self.weight}, self_feats,
                                agg_feats, gcn=self.gcn)


class Classifier(nn.Module):
    def __init__(self, emb_size: int, num_classes: int, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        p = init_classifier(generator, emb_size, num_classes, dtype)
        self.weight = nn.Parameter(p["weight"])
        self.bias = nn.Parameter(p["bias"])

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        return classifier_apply({"weight": self.weight, "bias": self.bias},
                                embeds)


class GraphSage(nn.Module):
    """The L-layer encoder (``cfg`` is a ``GraphSageConfig``).

    ``forward(h, idx, mask)`` encodes every row of ``h`` over one slot table
    ([N, S] ``idx`` into ``h``'s rows, ``mask`` their weights; in gcn mode
    the table includes the node's own slot), aggregating first and then
    transforming, as the JAX package's ``graphsage_apply`` does with every
    frontier equal to that table.  With LSTM each layer owns an
    ``LSTMAggregator`` whose hidden size is that layer's input size; the
    parameters are drawn layer by layer, the sage weight first, as
    ``init_graphsage`` draws them.  ``params()`` gives the JAX-layout dict
    ``{"layers": [{"weight"}]}`` (and ``"agg"``, the cells, with LSTM) of
    the live parameters."""

    def __init__(self, cfg, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if cfg.agg_func not in ("MEAN", "MAX", "LSTM"):
            raise ValueError(f"unknown agg_func {cfg.agg_func!r}")
        self.agg_func = cfg.agg_func
        layers, cells = [], []
        for i in range(cfg.num_layers):
            layers.append(SageLayer(cfg.layer_input_size(i), cfg.out_size,
                                    cfg.gcn, generator=generator,
                                    dtype=dtype))
            if cfg.agg_func == "LSTM":
                cells.append(LSTMAggregator(cfg.layer_input_size(i),
                                            generator=generator,
                                            dtype=dtype))
        self.layers = nn.ModuleList(layers)
        self.agg = nn.ModuleList(cells)

    def params(self) -> dict:
        out = {"layers": [{"weight": layer.weight} for layer in self.layers]}
        if self.agg_func == "LSTM":
            out["agg"] = [cell.params() for cell in self.agg]
        return out

    def forward(self, h: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if self.agg_func == "LSTM":
                agg = self.agg[i](h, idx, mask)
            elif self.agg_func == "MAX":
                agg = max_aggregate(h, idx, mask)
            else:
                agg = mean_aggregate(h, idx, mask)
            h = layer(h, agg)
        return h
