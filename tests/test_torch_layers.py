"""The port's dense layers (graphsage_torch.models) against the JAX package's
(graphsage_tpu.models), with the JAX weights carried over by
graphsage_torch.convert.params_from_jax and inputs made with numpy.

Tolerances: float32 rtol=1e-5, atol=1e-6 (the same products, taken in
another order).  bfloat16 outputs within one bf16 ulp: both round a float32
product once.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import graphsage as jax_graphsage
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models import layers as jax_layers
from graphsage_torch import convert
from graphsage_torch.models import (Classifier, GraphSage, GraphSageConfig,
                                    SageLayer, classifier_apply,
                                    init_classifier, init_graphsage,
                                    init_sage_layer, mean_pretransform,
                                    sage_layer_apply)
from tests.test_torch_aggregate import bf16_ulps


def _jax_layer(seed, input_size, out_size, gcn):
    return jax.device_get(jax_layers.init_sage_layer(
        jax.random.PRNGKey(seed), input_size, out_size, gcn=gcn))


@pytest.mark.parametrize("gcn", [False, True])
def test_mean_pretransform_column_order(gcn):
    """Non-gcn: [:, :H] = h @ W_self.T and [:, H:] = h @ W_agg.T."""
    rng = np.random.RandomState(0)
    h = rng.randn(23, 12).astype(np.float32)
    params = _jax_layer(1, 12, 8, gcn)
    w = convert.params_from_jax(params)["weight"]
    got = mean_pretransform(w, torch.from_numpy(h), gcn=gcn).numpy()
    want = np.asarray(jax_layers.mean_pretransform(
        jnp.asarray(params["weight"]), jnp.asarray(h), gcn=gcn))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if not gcn:
        w_np = params["weight"]
        np.testing.assert_allclose(got[:, :8], h @ w_np[:, :12].T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[:, 8:], h @ w_np[:, 12:].T,
                                   rtol=1e-5, atol=1e-6)


def test_mean_pretransform_bf16_matches_jax():
    """A bf16 table against f32 weights: both take the product in f32 and
    round once to bf16."""
    rng = np.random.RandomState(1)
    h = jnp.asarray(rng.randn(31, 12), dtype=jnp.bfloat16)
    params = _jax_layer(2, 12, 8, False)
    want = jax_layers.mean_pretransform(jnp.asarray(params["weight"]), h)
    got = mean_pretransform(convert.params_from_jax(params)["weight"],
                            torch.from_numpy(np.array(
                                h.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got.float().numpy(),
                     np.asarray(want.astype(jnp.float32))).max() <= 1.0


@pytest.mark.parametrize("gcn", [False, True])
def test_sage_layer_apply_matches_jax(gcn):
    rng = np.random.RandomState(2)
    self_f = rng.randn(17, 10).astype(np.float32)
    agg_f = rng.randn(17, 10).astype(np.float32)
    params = _jax_layer(3, 10, 6, gcn)
    got = sage_layer_apply(convert.params_from_jax(params),
                           torch.from_numpy(self_f), torch.from_numpy(agg_f),
                           gcn=gcn).numpy()
    want = jax_layers.sage_layer_apply(
        params, jnp.asarray(self_f), jnp.asarray(agg_f), gcn=gcn)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got >= 0).all()


def test_classifier_apply_matches_jax():
    rng = np.random.RandomState(3)
    emb = rng.randn(19, 16).astype(np.float32)
    params = jax.device_get(jax_layers.init_classifier(
        jax.random.PRNGKey(4), 16, 5))
    got = classifier_apply(convert.params_from_jax(params),
                           torch.from_numpy(emb)).numpy()
    want = jax_layers.classifier_apply(params, jnp.asarray(emb))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("gcn", [False, True])
def test_init_shapes_and_bounds(gcn):
    g = torch.Generator().manual_seed(0)
    w = init_sage_layer(g, 40, 24, gcn=gcn)["weight"]
    fan_in = 40 if gcn else 80
    assert w.shape == (24, fan_in) and w.dtype == torch.float32
    bound = math.sqrt(6.0 / (fan_in + 24))
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound

    clf = init_classifier(g, 24, 7)
    assert clf["weight"].shape == (7, 24) and clf["bias"].shape == (7,)
    assert clf["weight"].abs().max() <= math.sqrt(6.0 / 31)
    assert clf["bias"].abs().max() <= 1.0 / math.sqrt(24)

    cfg = GraphSageConfig(num_layers=3, input_size=40, out_size=24, gcn=gcn)
    layers = init_graphsage(g, cfg)["layers"]
    jax_layers_ = jax_init_graphsage(jax.random.PRNGKey(0), JaxConfig(
        num_layers=3, input_size=40, out_size=24, gcn=gcn))["layers"]
    assert ([tuple(p["weight"].shape) for p in layers]
            == [tuple(p["weight"].shape) for p in jax_layers_])


def test_init_is_seeded():
    cfg = GraphSageConfig(num_layers=2, input_size=9, out_size=5)
    a = init_graphsage(torch.Generator().manual_seed(7), cfg)
    b = init_graphsage(torch.Generator().manual_seed(7), cfg)
    c = init_graphsage(torch.Generator().manual_seed(8), cfg)
    assert torch.equal(a["layers"][1]["weight"], b["layers"][1]["weight"])
    assert not torch.equal(a["layers"][1]["weight"], c["layers"][1]["weight"])


def test_lstm_module_draws_as_init_graphsage():
    """GraphSage with LSTM holds a cell a layer of that layer's input size,
    drawn in init_graphsage's order (layer weight, then its cell)."""
    cfg = GraphSageConfig(num_layers=2, input_size=9, out_size=5,
                          agg_func="LSTM")
    want = init_graphsage(torch.Generator().manual_seed(4), cfg)
    got = GraphSage(cfg, generator=torch.Generator().manual_seed(4)).params()
    assert sorted(got) == ["agg", "layers"]
    flat_want = convert.flatten_params(want)
    flat_got = convert.flatten_params(got)
    assert sorted(flat_got) == sorted(flat_want)
    for k in flat_want:
        assert torch.equal(flat_got[k], flat_want[k]), k
    assert flat_got["agg/0/w_ih"].shape == (36, 9)


def test_modules_call_the_functions():
    g = torch.Generator().manual_seed(1)
    layer = SageLayer(6, 4, generator=g)
    clf = Classifier(4, 3, generator=g)
    x, a = torch.randn(5, 6, generator=g), torch.randn(5, 6, generator=g)
    h = layer(x, a)
    assert torch.equal(h, sage_layer_apply({"weight": layer.weight}, x, a))
    assert torch.equal(clf(h), classifier_apply(
        {"weight": clf.weight, "bias": clf.bias}, h))
    assert [n for n, _ in clf.named_parameters()] == ["weight", "bias"]


@pytest.mark.parametrize("agg,gcn", [("MEAN", False), ("MEAN", True),
                                     ("MAX", False), ("MAX", True),
                                     ("LSTM", False), ("LSTM", True)])
def test_graphsage_module_matches_jax_graphsage_apply(agg, gcn):
    """GraphSage.forward over one slot table == the JAX encoder with every
    frontier equal to that table (self_idx = the row itself)."""
    rng = np.random.RandomState(5)
    n, s = 29, 6
    h = rng.randn(n, 10).astype(np.float32)
    idx = rng.randint(0, n, (n, s)).astype(np.int32)
    mask = (rng.rand(n, s) < 0.7).astype(np.float32)
    jcfg = JaxConfig(num_layers=2, input_size=10, out_size=7, agg_func=agg,
                     gcn=gcn)
    jparams = jax.device_get(jax_init_graphsage(jax.random.PRNGKey(6), jcfg))
    frontier = jax_graphsage.Frontier(
        idx=jnp.asarray(idx), mask=jnp.asarray(mask),
        self_idx=jnp.arange(n, dtype=jnp.int32))
    want = jax_graphsage.graphsage_apply(jparams, jcfg, jnp.asarray(h),
                                         [frontier, frontier])

    model = GraphSage(GraphSageConfig(num_layers=2, input_size=10,
                                      out_size=7, agg_func=agg, gcn=gcn),
                      generator=torch.Generator())
    with torch.no_grad():
        flat = convert.flatten_params(model.params())
        for key, value in convert.flatten_params(jparams).items():
            flat[key].copy_(torch.from_numpy(np.array(value)))
        got = model(torch.from_numpy(h), torch.from_numpy(idx),
                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_params_roundtrip_through_numpy():
    jparams = jax.device_get({
        "sage": jax_init_graphsage(jax.random.PRNGKey(9), JaxConfig(
            num_layers=2, input_size=8, out_size=4)),
        "clf": jax_layers.init_classifier(jax.random.PRNGKey(10), 4, 3)})
    tparams = convert.params_from_jax(jparams)
    assert isinstance(tparams["sage"]["layers"][1]["weight"], torch.Tensor)
    back = convert.params_to_numpy(tparams)
    flat_j = convert.flatten_params(jparams)
    flat_b = convert.flatten_params(back)
    assert sorted(flat_j) == ["clf/bias", "clf/weight",
                              "sage/layers/0/weight", "sage/layers/1/weight"]
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k])
    again = convert.unflatten_params(flat_b)
    assert len(again["sage"]["layers"]) == 2
    np.testing.assert_array_equal(again["clf"]["bias"], jparams["clf"]["bias"])


def test_bf16_leaves_convert():
    x = jnp.asarray(np.linspace(-2, 2, 6), dtype=jnp.bfloat16)
    t = convert.params_from_jax({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
