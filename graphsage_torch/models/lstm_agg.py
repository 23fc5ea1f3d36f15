"""The LSTM neighbourhood aggregator.

Port of ``graphsage_tpu/models/lstm_agg.py`` (the GraphSAGE paper's LSTM
aggregator, Hamilton et al. 2017, section 3.1; the reference has MEAN and MAX
only).  A node's neighbours arrive as a fixed-length padded slot sequence
[U, S, D] with a validity mask; an LSTM cell scans the S slots, masked slots
pass (h, c) through unchanged, and the last hidden state is the aggregate.
The hidden size equals the input size, so the aggregate concatenates with
the node's own row as the MEAN and MAX aggregates do.

Parameters are a dict ``{"w_ih": [4H, D], "w_hh": [4H, H], "b_ih": [4H],
"b_hh": [4H]}`` with the gates packed [i, f, g, o], the JAX package's layout,
so ``graphsage_torch.convert.params_from_jax`` carries a JAX cell over
unchanged.

The slot gather is ``ops.gather.gather_rows`` (the hand-written
``gather_rows`` CUDA kernel on the card, with the ``scatter_rows`` backward);
the cell is ``torch.matmul`` and PyTorch elementwise work, as the JAX package
leaves it to XLA.  Each scan step is recomputed in the backward
(``torch.utils.checkpoint``, the counterpart of the JAX package's
``jax.checkpoint``): the per-slot [U, 4H] gate activations are not kept.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graphsage_torch.ops.gather import gather_rows

_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def init_lstm_agg(generator: torch.Generator, feat_size: int,
                  dtype: torch.dtype = torch.float32) -> dict:
    """A cell of hidden size ``feat_size``: each parameter Uniform(+-1/sqrt(H))
    (``torch.nn.LSTM``'s default), drawn from ``generator`` in the order
    w_ih, w_hh, b_ih, b_hh."""
    h = feat_size
    bound = 1.0 / math.sqrt(h)
    shapes = {"w_ih": (4 * h, feat_size), "w_hh": (4 * h, h),
              "b_ih": (4 * h,), "b_hh": (4 * h,)}
    return {k: torch.empty(shapes[k], dtype=dtype).uniform_(
        -bound, bound, generator=generator) for k in _KEYS}


def _lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step, with the JAX package's cast points
    (``lstm_agg.py:48-56``): the gates in the input dtype, the summed bias
    cast to it, the cell state ``c`` in float32, and
    ``h_new = o * tanh(c_new)`` with the tanh cast to the input dtype.  In
    bfloat16 the gate GEMMs return bfloat16, as JAX's ``jnp.dot`` without
    ``preferred_element_type`` does; their sums run in float32 (see
    ``models/layers.py`` on cuBLAS's bfloat16 reductions)."""
    gates = (torch.matmul(x, params["w_ih"].T.to(x.dtype))
             + torch.matmul(h, params["w_hh"].T.to(h.dtype))
             + (params["b_ih"] + params["b_hh"]).to(x.dtype))
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f.float() * c + i.float() * g.float()
    h_new = o * torch.tanh(c_new).to(x.dtype)
    return h_new, c_new


def _masked_step(params: dict, x: torch.Tensor, m: torch.Tensor,
                 h: torch.Tensor, c: torch.Tensor):
    """The scan step: a masked slot (m = 0) keeps (h, c), in the JAX
    package's blend form m * new + (1 - m) * old."""
    h_new, c_new = _lstm_cell(params, x, h, c)
    mh = m[:, None].to(h.dtype)
    mc = m[:, None].to(c.dtype)
    return mh * h_new + (1 - mh) * h, mc * c_new + (1 - mc) * c


def lstm_scan(params: dict, gathered: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The LSTM over an already materialised slot sequence [U, S, D] with a
    [U, S] validity mask; returns the last hidden state [U, D].  The
    cached-LSTM hybrid calls it on the tree-contiguous reshape of its upper
    layers, with no gather.  The zero initial state is made from the input
    (``gathered[:, 0] * 0``), as in the JAX package."""
    h = gathered[:, 0] * 0
    c = gathered[:, 0].float() * 0                  # float32 cell state
    remat = torch.is_grad_enabled()
    for s in range(gathered.shape[1]):
        x, m = gathered[:, s], mask[:, s]
        if remat:
            h, c = checkpoint(_masked_step, params, x, m, h, c,
                              use_reentrant=False)
        else:
            h, c = _masked_step(params, x, m, h, c)
    return h


def lstm_aggregate(params: dict, embed: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Aggregate with the LSTM: embed [M, D], idx [U, S] int32, mask [U, S]
    -> [U, D].  One ``gather_rows`` of the U x S slot rows, then
    :func:`lstm_scan`."""
    u, s = idx.shape
    gathered = gather_rows(embed, idx.reshape(-1)).view(u, s, embed.shape[1])
    return lstm_scan(params, gathered, mask)


class LSTMAggregator(nn.Module):
    """The cell's parameters as ``nn.Parameter``s (drawn as
    :func:`init_lstm_agg` draws them); ``forward(embed, idx, mask)`` is
    :func:`lstm_aggregate`."""

    def __init__(self, feat_size: int, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        for k, v in init_lstm_agg(generator, feat_size, dtype).items():
            setattr(self, k, nn.Parameter(v))

    def params(self) -> dict:
        return {k: getattr(self, k) for k in _KEYS}

    def forward(self, embed: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return lstm_aggregate(self.params(), embed, idx, mask)
