"""The port's dense pipeline (graphsage_torch.train.dense) and its flagship
entry (graphsage_torch.entry) against the JAX package's
(graphsage_tpu.train.dense, __graft_entry__.entry), on the CPU, in float32,
with the JAX package's sampler draws replayed through ``JaxHop`` and JAX's
params carried over with ``params_from_jax``.  This float32 check is what
proves the algorithm; tests/test_torch_bf16.py holds the bfloat16 paths.

Tolerances (float32, the same sums and products in another order):
- ``dense_forward``: rtol = atol = 1e-5;
- one sup / unsup / plus_unsup step (lr 0.7): loss rtol 1e-5, updated
  params atol 1e-6;
- an epoch of T = 3 steps: losses rtol 1e-5, final params atol 1e-6;
- ``edges_per_batch``: equal.
"""

import types

import __graft_entry__
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models.layers import init_classifier as jax_init_clf
from graphsage_tpu.sampler import PairSampler as JaxPairSampler
from graphsage_tpu.train import dense as jd
from graphsage_tpu.train.trainer import _pair_tensors as jax_pair_tensors
from graphsage_torch import entry
from graphsage_torch.convert import params_from_jax
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import dense
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_cached import JaxHop, _t

N, D, H, C, FANOUT = 400, 32, 16, 4, 4
FWD = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    ds = jax_power_law(N, 6 * N, num_feats=D, num_classes=C, seed=7)
    return ds, ds.graph.to_padded(cap=16)


def _jcfg(**kw):
    return JaxConfig(num_layers=2, input_size=D, out_size=H, **kw)


def _port_cfg(jcfg):
    return GraphSageConfig(**jcfg.__dict__)


def _params(jcfg):
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    return jax.device_get({"sage": jax_init_graphsage(k1, jcfg),
                           "clf": jax_init_clf(k2, jcfg.out_size, C)})


def _tables(ds, pad):
    return (jnp.asarray(ds.features), jnp.asarray(pad.neighbors),
            jnp.asarray(pad.degrees))


def _assert_params_close(got, want, atol):
    flat_got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.detach().numpy(), got))
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
@pytest.mark.parametrize("gcn", [False, True])
@pytest.mark.parametrize("b", [2, 16], ids=["x0_gather", "table"])
def test_dense_forward_matches_jax(graph, agg, gcn, b):
    """Both forms of graphsage_apply_gathered: at b = 16 the 400-row table
    has no more than twice the 400 frontier rows, so MEAN transforms the
    table once; at b = 2 it gathers the x0 rows."""
    ds, pad = graph
    jcfg = _jcfg(agg_func=agg, gcn=gcn)
    params = _params(jcfg)
    batch = (np.arange(b, dtype=np.int32) * 7) % N
    key = jax.random.PRNGKey(11)
    want = jax.jit(jd.dense_forward, static_argnums=(1, 7))(
        params, jcfg, *_tables(ds, pad), jnp.asarray(batch), key, FANOUT)
    hop = JaxHop(jax.random.split(key, 2), pad)
    with torch.no_grad():
        got = dense.dense_forward(params_from_jax(params), _port_cfg(jcfg),
                                  _t(ds.features), hop, _t(batch), FANOUT)
    assert not hop.keys
    assert got.shape == (b, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_dense_sup_step_matches_jax(graph):
    ds, pad = graph
    jcfg = _jcfg()
    params = _params(jcfg)
    batch = ds.train_nodes[:24].astype(np.int32)
    labels = ds.labels[batch].astype(np.int32)
    key = jax.random.PRNGKey(5)
    step = jax.jit(jd.make_dense_sup_step(jcfg, fanout=FANOUT, lr=0.7))
    want_p, want_loss = step(params, *_tables(ds, pad), jnp.asarray(batch),
                             jnp.asarray(labels), key)
    p = _leaf_params(params, CPU)
    loss = dense.make_dense_sup_step(_port_cfg(jcfg), fanout=FANOUT,
                                     lr=0.7)(
        p, _t(ds.features), JaxHop(jax.random.split(key, 2), pad),
        _t(batch), _t(labels))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_params_close(p, want_p, atol=1e-6)


@pytest.mark.parametrize("kind,method", [
    ("normal", "unsup"), ("margin", "unsup"), ("normal", "plus_unsup"),
    ("margin", "plus_unsup")])
def test_dense_unsup_step_matches_jax(graph, kind, method, monkeypatch):
    """The extended batch is bucket-padded with node 0; the row mask keeps
    those rows out of plus_unsup's NLL."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, pad = graph
    jcfg = _jcfg()
    params = _params(jcfg)
    rng = np.random.RandomState(1)
    nodes = ds.train_nodes[rng.choice(len(ds.train_nodes), 16,
                                      replace=False)]
    pb = JaxPairSampler(ds.graph, ds.train_nodes).sample_batch(
        nodes, num_neg=6 if kind == "margin" else 20, rng=rng)
    assert pb.num_unique < len(pb.unique_nodes)
    batch = pb.unique_nodes.astype(np.int32)
    labels = ds.labels[batch].astype(np.int32)
    row_mask = (np.arange(len(batch)) < pb.num_unique).astype(np.float32)
    key = jax.random.PRNGKey(2)
    step = jax.jit(jd.make_dense_unsup_step(jcfg, unsup_loss=kind,
                                            fanout=FANOUT, lr=0.7,
                                            learn_method=method))
    want_p, want_loss = step(params, *_tables(ds, pad), jnp.asarray(batch),
                             jnp.asarray(labels), jax_pair_tensors(pb), key,
                             jnp.asarray(row_mask))
    p = _leaf_params(params, CPU)
    port_step = dense.make_dense_unsup_step(_port_cfg(jcfg), unsup_loss=kind,
                                            fanout=FANOUT, lr=0.7,
                                            learn_method=method)
    loss = port_step(p, _t(ds.features),
                     JaxHop(jax.random.split(key, 2), pad), _t(batch),
                     _t(labels),
                     {k: _t(v) for k, v in jax_pair_tensors(pb).items()},
                     _t(row_mask))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_params_close(p, want_p, atol=1e-6)


def test_dense_sup_epoch_matches_jax(graph):
    """Three steps against JAX's scanned epoch, each step's hops drawn with
    the subkey the scan splits off for it."""
    ds, pad = graph
    jcfg = _jcfg()
    params = _params(jcfg)
    rng = np.random.RandomState(4)
    batches = rng.choice(ds.train_nodes, (3, 16)).astype(np.int32)
    labels = ds.labels[batches].astype(np.int32)
    key = jax.random.PRNGKey(8)
    epoch = jax.jit(jd.make_dense_sup_epoch(jcfg, fanout=FANOUT, lr=0.7))
    want_p, want_losses = epoch(params, *_tables(ds, pad),
                                jnp.asarray(batches), jnp.asarray(labels),
                                key)
    keys, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        keys.extend(jax.random.split(sub, 2))
    hop = JaxHop(keys, pad)
    p = _leaf_params(params, CPU)
    losses = dense.make_dense_sup_epoch(_port_cfg(jcfg), fanout=FANOUT,
                                        lr=0.7)(
        p, _t(ds.features), hop, _t(batches), _t(labels))
    assert not hop.keys
    assert losses.shape == (3,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=1e-5)
    _assert_params_close(p, want_p, atol=1e-6)


@pytest.mark.parametrize("b,layers,fanout", [
    (4096, 2, 10), (65536, 2, 10), (1, 1, 1), (7, 3, 5), (16, 2, 3)])
def test_edges_per_batch_matches_jax(b, layers, fanout):
    assert (dense.edges_per_batch(b, layers, fanout)
            == jd.edges_per_batch(b, layers, fanout))


def test_entry_forward_matches_jax():
    """graphsage_torch.entry's forward against __graft_entry__.entry()'s:
    the same graph, features and batch; JAX's params and draws carried
    over."""
    jfn, (jparams, jfeats, jneigh, jdeg, jbatch, jkey) = (
        __graft_entry__.entry())
    want = jax.jit(jfn)(jparams, jfeats, jneigh, jdeg, jbatch, jkey)
    fn, (params, feats, hop, batch) = entry.entry(device="cpu")
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    np.testing.assert_array_equal(hop.neighbors.numpy(), np.asarray(jneigh))
    assert {k: v.shape for k, v in params["clf"].items()} == {
        k: v.shape for k, v in jparams["clf"].items()}
    pad = types.SimpleNamespace(neighbors=np.asarray(jneigh),
                                degrees=np.asarray(jdeg))
    replay = JaxHop(jax.random.split(jkey, 2), pad)
    with torch.no_grad():
        got = fn(params_from_jax(jax.device_get(jparams)), feats, replay,
                 batch)
    assert got.shape == (16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    with torch.no_grad():
        own = fn(*(params, feats, hop, batch))
    assert own.shape == (16, 32) and torch.isfinite(own).all()
