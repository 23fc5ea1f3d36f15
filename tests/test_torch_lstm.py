"""The port's LSTM aggregator (graphsage_torch.models.lstm_agg) against the
JAX package's (graphsage_tpu.models.lstm_agg), on the CPU, with the JAX
cell's weights carried over by params_from_jax and inputs made with numpy.

Tolerances:
- float32 forward and gradients (cell parameters and inputs): rtol 1e-5,
  atol 1e-6; the same products and sums in another order, over at most 7
  recurrence steps;
- bfloat16 forward (bf16 slot rows, float32 parameters cast to bf16 as
  both packages do): within 4 bf16 ulps of the JAX value, at the scale of
  the row's largest magnitude.  Both round every gate and product to bf16,
  but the two libraries round the GEMMs' float32 sums and the activations
  at different points; a one-ulp difference in a gate carries through the
  recurrence.  Measured on a CPU over 20 input seeds: at most 3 ulps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models import lstm_agg as jl
from graphsage_torch.convert import params_from_jax
from graphsage_torch.models import (GraphSageConfig, LSTMAggregator,
                                    init_graphsage, init_lstm_agg, lstm_agg)

F32 = dict(rtol=1e-5, atol=1e-6)


def _cell(d, seed=0):
    return jax.device_get(jl.init_lstm_agg(jax.random.PRNGKey(seed), d))


def _inputs(u=9, s=7, d=6, m=15, seed=1):
    """embed [m, d], idx [u, s], mask [u, s] with a row of no valid slot, a
    row with its only valid slot last, and masked slots between valid
    ones."""
    rng = np.random.RandomState(seed)
    embed = rng.randn(m, d).astype(np.float32)
    idx = rng.randint(0, m, (u, s)).astype(np.int32)
    mask = (rng.rand(u, s) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, -1] = 1.0
    return embed, idx, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(params):
    return {k: _t(v).requires_grad_(True) for k, v in params.items()}


def test_cell_matches_jax_with_gradients():
    rng = np.random.RandomState(2)
    u, d = 11, 5
    x, h = (rng.randn(u, d).astype(np.float32) for _ in range(2))
    c = rng.randn(u, d).astype(np.float32)
    w_h, w_c = rng.randn(u, d).astype(np.float32), rng.randn(u, d)
    params = _cell(d)

    def jax_loss(p, x, h, c):
        h_new, c_new = jl._lstm_cell(p, x, h, c)
        return jnp.sum(h_new * w_h) + jnp.sum(c_new * w_c), (h_new, c_new)

    (_, (want_h, want_c)), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    p = _leaves(params)
    xt, ht, ct = (_t(a).requires_grad_(True) for a in (x, h, c))
    got_h, got_c = lstm_agg._lstm_cell(p, xt, ht, ct)
    assert got_c.dtype == torch.float32
    ((got_h * _t(w_h)).sum() + (got_c * _t(w_c)).sum()).backward()
    np.testing.assert_allclose(got_h.detach().numpy(), want_h, **F32)
    np.testing.assert_allclose(got_c.detach().numpy(), want_c, **F32)
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), want_g[0][k], **F32)
    for got, want in zip((xt, ht, ct), want_g[1:]):
        np.testing.assert_allclose(got.grad.numpy(), want, **F32)


@pytest.mark.parametrize("fn", ["lstm_scan", "lstm_aggregate"])
def test_scan_and_aggregate_match_jax_with_gradients(fn):
    embed, idx, mask = _inputs()
    params = _cell(embed.shape[1], seed=3)
    w = np.random.RandomState(4).randn(idx.shape[0], embed.shape[1])

    def run_jax(p, e):
        if fn == "lstm_scan":
            return jl.lstm_scan(p, jnp.take(e, jnp.asarray(idx), axis=0),
                                jnp.asarray(mask))
        return jl.lstm_aggregate(p, e, jnp.asarray(idx), jnp.asarray(mask))

    def jax_loss(p, e):
        out = run_jax(p, e)
        return jnp.sum(jnp.sin(out) * w), out

    (_, want), (want_p, want_e) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(embed))
    p = _leaves(params)
    e = _t(embed).requires_grad_(True)
    if fn == "lstm_scan":
        got = lstm_agg.lstm_scan(p, e[_t(idx).long()], _t(mask))
    else:
        got = lstm_agg.lstm_aggregate(p, e, _t(idx), _t(mask))
    (torch.sin(got) * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    # a row with no valid slot keeps the zero state
    assert not got[0].any()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), want_p[k], **F32)
    np.testing.assert_allclose(e.grad.numpy(), want_e, **F32)


def test_scan_recomputes_steps_only_under_grad(monkeypatch):
    """Each step runs under torch.utils.checkpoint when autograd records
    (the counterpart of jax.checkpoint), and plainly under no_grad; the
    values are the same."""
    embed, idx, mask = _inputs(seed=5)
    p = _leaves(_cell(embed.shape[1], seed=6))
    seq = _t(embed)[_t(idx).long()]
    calls = []
    real = lstm_agg.checkpoint

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(lstm_agg, "checkpoint", counting)
    with torch.no_grad():
        plain = lstm_agg.lstm_scan(p, seq, _t(mask))
    assert calls == []
    remat = lstm_agg.lstm_scan(p, seq, _t(mask))
    assert calls == [{"use_reentrant": False}] * idx.shape[1]
    assert torch.equal(plain, remat.detach())


def test_bf16_forward_within_ulps_of_jax():
    embed, idx, mask = _inputs(u=40, s=7, d=16, m=60, seed=7)
    params = _cell(16, seed=8)
    e16 = jnp.asarray(embed, dtype=jnp.bfloat16)
    want = np.asarray(jl.lstm_aggregate(params, e16, jnp.asarray(idx),
                                        jnp.asarray(mask)
                                        ).astype(jnp.float32))
    got = lstm_agg.lstm_aggregate(
        params_from_jax(params), _t(np.asarray(e16.astype(jnp.float32))
                                    ).bfloat16(), _t(idx), _t(mask))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
        np.abs(want).max(axis=1, keepdims=True), 2.0**-126))) - 7)
    assert (np.abs(got.float().numpy() - want) <= 4 * ulp).all()


def test_init_matches_jax_layout_and_bounds():
    """Keys, shapes and dtypes of the JAX package's cell, Uniform(+-1/sqrt(H))
    draws from the generator in a fixed order; init_graphsage gives every
    layer a cell of its input size, and the sage weights of an LSTM model
    are the MEAN model's from the same seed only at layer 0 (the cell is
    drawn between layers)."""
    cell = init_lstm_agg(torch.Generator().manual_seed(1), 20)
    jcell = jl.init_lstm_agg(jax.random.PRNGKey(0), 20)
    assert list(cell) == list(jcell)
    for k in cell:
        assert tuple(cell[k].shape) == tuple(jcell[k].shape)
        assert cell[k].dtype == torch.float32
        assert cell[k].abs().max() <= 1 / math.sqrt(20)
        assert cell[k].abs().max() > 0.9 / math.sqrt(20)
    again = init_lstm_agg(torch.Generator().manual_seed(1), 20)
    assert all(torch.equal(cell[k], again[k]) for k in cell)

    cfg = GraphSageConfig(num_layers=2, input_size=10, out_size=6,
                          agg_func="LSTM")
    params = init_graphsage(torch.Generator().manual_seed(2), cfg)
    jparams = jax_init_graphsage(jax.random.PRNGKey(0), JaxConfig(
        num_layers=2, input_size=10, out_size=6, agg_func="LSTM"))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                            jparams)
    assert [c["w_ih"].shape for c in params["agg"]] == [(40, 10), (24, 6)]
    mean = init_graphsage(torch.Generator().manual_seed(2), GraphSageConfig(
        num_layers=2, input_size=10, out_size=6))
    assert "agg" not in mean
    assert torch.equal(mean["layers"][0]["weight"],
                       params["layers"][0]["weight"])


def test_module_holds_the_cell():
    g = torch.Generator().manual_seed(3)
    module = LSTMAggregator(6, generator=g)
    want = init_lstm_agg(torch.Generator().manual_seed(3), 6)
    assert [n for n, _ in module.named_parameters()] == list(want)
    embed, idx, mask = _inputs(seed=9)
    got = module(_t(embed), _t(idx), _t(mask))
    assert torch.equal(got, lstm_agg.lstm_aggregate(
        want, _t(embed), _t(idx), _t(mask)))
