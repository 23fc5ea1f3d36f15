"""The port's leaf-cached pipeline (graphsage_torch.train.cached and
.cached_trainer) against the JAX package's (graphsage_tpu.train.cached), on
the CPU, with the JAX package's random draws replayed.

``torch.Generator`` cannot reproduce ``jax.random``, so every port call
here samples through ``JaxHop``: its i-th call returns what
``graphsage_tpu.sampler.device._sample_one_hop`` draws with the i-th key
of the key sequence the JAX function under comparison uses.

Tolerances (float32; the same sums in another order):
- refresh: rtol=atol=1e-6 (MEAN); MAX exact; counts exact;
- forwards: rtol=atol=1e-5; parameter gradients rtol=atol=1e-5;
- one step: loss rtol 1e-4, updated params atol 1e-5;
- an epoch of 4 steps at lr 0.7: losses rtol 1e-4, params atol 1e-4;
- a whole fit with the JAX draws replayed (MAX gcn; the cached-LSTM
  hybrid): losses rtol 1e-4, final params atol 1e-4.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data import CSRGraph
from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models.graphsage import Frontier as JaxFrontier
from graphsage_tpu.models.layers import init_classifier as jax_init_clf
from graphsage_tpu.sampler import PairSampler as JaxPairSampler
from graphsage_tpu.sampler.device import _sample_one_hop as jax_one_hop
from graphsage_tpu.train import cached as jc
from graphsage_tpu.train.trainer import _pair_tensors as jax_pair_tensors
from graphsage_torch import infer
from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import Frontier, GraphSageConfig
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import CachedTrainer, TrainConfig
from graphsage_torch.train import cached
from graphsage_torch.train.trainer import _leaf_params

FWD = dict(rtol=1e-5, atol=1e-5)
N, D, H, FANOUT = 300, 16, 8, 4
CPU = torch.device("cpu")


class JaxHop:
    """A hop sampler that replays JAX draws: call i samples with keys[i]
    over the same padded adjacency.  With ``block``, a call draws as the
    JAX package's blocked refresh does (``cached.py:107-125``): the ids
    padded to whole blocks with n-1, one key of split(keys[i], blocks) per
    block, the tail sliced off."""

    def __init__(self, keys, pad, block=None):
        self.keys = list(keys)
        self.neighbors = jnp.asarray(pad.neighbors)
        self.degrees = jnp.asarray(pad.degrees)
        self.block = block

    def __call__(self, nodes, fanout):
        key, ids = self.keys.pop(0), jnp.asarray(nodes.numpy())
        if self.block is None:
            samples, valid = jax_one_hop(key, self.neighbors, self.degrees,
                                         ids, fanout)
            return _t(samples), _t(valid)
        n, nb = ids.shape[0], -(-ids.shape[0] // self.block)
        padded = jnp.concatenate(
            [ids, jnp.full(nb * self.block - n, ids[-1], ids.dtype)])
        draws = [jax_one_hop(k, self.neighbors, self.degrees,
                             padded[i * self.block:(i + 1) * self.block],
                             fanout)
                 for i, k in enumerate(jax.random.split(key, nb))]
        return (_t(jnp.concatenate([d[0] for d in draws])[:n]),
                _t(jnp.concatenate([d[1] for d in draws])[:n]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_cfg(jcfg):
    return GraphSageConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def graph():
    ds = jax_power_law(N, 5 * N, num_feats=D, num_classes=4, seed=4)
    return ds, ds.graph.to_padded()


def _jax_cache(ds, pad, agg, key):
    return jc.refresh_leaf_cache(key, jnp.asarray(ds.features),
                                 jnp.asarray(pad.neighbors),
                                 jnp.asarray(pad.degrees), FANOUT, agg=agg)


def _hop_keys(key, num_hops):
    """The keys sample_frontiers_dense(key, ...) draws its hops with."""
    return list(jax.random.split(key, num_hops))


# ------------------------------------------------------------ refresh

@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
@pytest.mark.parametrize("blocking,jax_block", [
    (dict(), None), (dict(block=64), 64), (dict(max_gather_bytes=1), 1024)],
    ids=["one_shot", "block64_tail", "auto_blocked"])
def test_refresh_matches_jax(graph, agg, blocking, jax_block):
    """The port's one-shot refresh against the JAX package's one shot, its
    forced block of 64 over 300 nodes (a clamped tail block) and its
    automatic blocked form (block 1024 > N, one block), each with the JAX
    draws of that form replayed."""
    ds, pad = graph
    key = jax.random.PRNGKey(9)
    want_f, want_c = jc.refresh_leaf_cache(
        key, jnp.asarray(ds.features), jnp.asarray(pad.neighbors),
        jnp.asarray(pad.degrees), FANOUT, agg=agg, **blocking)
    hop = JaxHop([key], pad, block=jax_block)
    got_f, got_c = cached.refresh_leaf_cache(hop, _t(ds.features), FANOUT,
                                             agg=agg)
    assert not hop.keys
    assert got_f.shape == (N, D) and got_c.shape == (N,)
    if agg == "MAX":
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    else:
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ------------------------------------------------------------ gcn mix

@pytest.mark.parametrize("is_max", [False, True])
def test_gcn_mix_matches_jax(is_max):
    rng = np.random.RandomState(0)
    self_f = rng.randn(9, 5).astype(np.float32)
    agg_f = rng.randn(9, 5).astype(np.float32)
    cnt = rng.randint(0, 4, 9).astype(np.float32)
    cnt[[0, 4]] = 0.0                                     # empty samples
    for c in (cnt, cnt[:, None]):
        want = jc._gcn_mix(jnp.asarray(self_f), jnp.asarray(agg_f),
                           jnp.asarray(c), is_max)
        got = cached._gcn_mix(_t(self_f), _t(agg_f), _t(c), is_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    if is_max:
        np.testing.assert_array_equal(got[0].numpy(), self_f[0])


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("agg", ["MEAN", "MAX", "LSTM"])
@pytest.mark.parametrize("gcn", [False, True])
@pytest.mark.parametrize("b", [8, 32], ids=["per_occurrence", "full_table"])
def test_cached_forward_matches_jax_in_both_branches(graph, agg, gcn, b):
    """b=8 (m1=40) takes the per-occurrence branch by the byte rule, b=32
    (m1=160) the full table, in both packages; the port is also run with
    the other branch forced, which must give the same values and
    gradients.  LSTM is the cached-LSTM hybrid: the layer-2 cell gets the
    JAX gradient, the layer-0 cell none."""
    ds, pad = graph
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H, gcn=gcn,
                     agg_func=agg)
    params = jax.device_get({"sage": jax_init_graphsage(
        jax.random.PRNGKey(3), jcfg)})
    cache_f, cache_c = _jax_cache(ds, pad, agg, jax.random.PRNGKey(6))
    batch = np.random.RandomState(b).choice(N, b, replace=False).astype(
        np.int32)
    key = jax.random.PRNGKey(7)
    w_out = np.random.RandomState(1).randn(b, H).astype(np.float32)
    args = (jnp.asarray(ds.features), cache_f, cache_c,
            jnp.asarray(pad.neighbors), jnp.asarray(pad.degrees),
            jnp.asarray(batch), key)

    def jax_loss(p):
        out = jc.cached_forward(p, jcfg, *args, fanout=FANOUT)
        return jnp.sum(jnp.sin(out) * w_out), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    rule = cached.layer1_full_table(N, D, b * (FANOUT + 1), H)
    assert rule == (b == 32)
    for full_table in (rule, not rule):
        p = _leaf_params(params, CPU)
        ids, frontiers = cached.sample_cached_frontiers(
            JaxHop(_hop_keys(key, 1), pad), _t(batch), _port_cfg(jcfg),
            FANOUT)
        got = cached.cached_forward(p, _port_cfg(jcfg), _t(ds.features),
                                    _t(cache_f), _t(cache_c), ids, frontiers,
                                    FANOUT, full_table=full_table)
        (torch.sin(got) * _t(w_out)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)
        for layer, jlayer in zip(p["sage"]["layers"],
                                 want_g["sage"]["layers"]):
            np.testing.assert_allclose(layer["weight"].grad.numpy(),
                                       np.asarray(jlayer["weight"]), **FWD)
        if agg == "LSTM":
            cell0, cell1 = p["sage"]["agg"]
            assert all(v.grad is None for v in cell0.values())
            assert not any(np.asarray(v).any()
                           for v in want_g["sage"]["agg"][0].values())
            for k, v in cell1.items():
                np.testing.assert_allclose(
                    v.grad.numpy(), np.asarray(want_g["sage"]["agg"][1][k]),
                    **FWD)


def test_cached_forward_equals_full_graph_embeddings_under_take_all():
    """RNG-free oracle: with every degree at most the fanout, sampling is
    take-all, so the cached forward of a batch equals exact full-graph
    inference (infer.full_graph_embeddings) on those rows, whatever the
    generator draws."""
    rng = np.random.RandomState(0)
    n = 40
    src = np.concatenate([np.arange(n), rng.randint(0, n, 60)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.randint(0, n, 60)])
    keep = src != dst
    g = CSRGraph.from_edges(n, src[keep], dst[keep])
    pad = g.to_padded()
    fanout = int(g.degrees.max()) + 1
    feats = rng.randn(n, 8).astype(np.float32)
    batch = torch.from_numpy(rng.choice(n, 7, replace=False))
    hop = HopSampler(_t(pad.neighbors), _t(pad.degrees),
                     torch.Generator().manual_seed(0))
    for agg in ("MEAN", "MAX"):
        for gcn in (False, True):
            kw = dict(num_layers=2, input_size=8, out_size=6, gcn=gcn,
                      agg_func=agg)
            cfg = GraphSageConfig(**kw)
            params = params_from_jax({"sage": jax.device_get(
                jax_init_graphsage(jax.random.PRNGKey(3), JaxConfig(**kw)))})
            cache = cached.refresh_leaf_cache(hop, _t(feats), fanout, agg=agg)
            ids, frontiers = cached.sample_cached_frontiers(hop, batch, cfg,
                                                            fanout)
            with torch.no_grad():
                got = cached.cached_forward(params, cfg, _t(feats), *cache,
                                            ids, frontiers, fanout)
            want = infer.full_graph_embeddings(params["sage"], cfg, feats,
                                               pad, device="cpu")
            np.testing.assert_allclose(got.numpy(), want[batch.numpy()],
                                       **FWD)


# ------------------------------------------------------------ upper layers

@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
def test_upper_layers_and_max_gradient_at_ties_match_jax(agg):
    """Layer 2 on a relu'd activation with tied maxima (zeros, and equal
    rows) and an all-masked row: the values and the gradient, which JAX
    splits equally among tied maxima; the all-masked row gets a zero
    gradient, not a NaN."""
    rng = np.random.RandomState(2)
    u, k, h = 6, 3, 5
    x = np.maximum(rng.randn(u * (k + 1), h), 0).astype(np.float32)
    x[2] = x[3]                                 # equal rows of parent 0
    mask = (rng.rand(u, k + 1) < 0.7).astype(np.float32)
    mask[0, 1:] = 1.0
    mask[4] = 0.0                               # no valid slot
    w = rng.randn(h, 2 * h).astype(np.float32)
    g = rng.randn(u, h).astype(np.float32)
    jax_frontier = [JaxFrontier(idx=None, mask=jnp.asarray(mask),
                                self_idx=None)]

    def jax_fn(xx):
        out = jc._upper_layers({"layers": [None, {"weight": jnp.asarray(w)}]},
                               xx, jax_frontier, k, agg, False)
        return jnp.sum(out * g)

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = cached._upper_layers(
        {"layers": [None, {"weight": _t(w)}]}, xt,
        [Frontier(idx=None, mask=_t(mask), self_idx=None)], k, agg, False)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jc._upper_layers(
                                   {"layers": [None, {"weight": w}]},
                                   jnp.asarray(x), jax_frontier, k, agg,
                                   False)), **FWD)
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), **FWD)
    assert not xt.grad[4 * (k + 1) + 1:5 * (k + 1)].any()


# ------------------------------------------------------------ steps

def _params(jcfg, classes):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return jax.device_get({"sage": jax_init_graphsage(k1, jcfg),
                           "clf": jax_init_clf(k2, jcfg.out_size, classes)})


def _assert_params_close(got, want, atol):
    flat_got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.detach().numpy(), got))
    for g, w in zip(flat_got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("learn_method", ["sup", "plus_unsup"])
def test_one_step_matches_jax(graph, learn_method, monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, pad = graph
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H, agg_func="MAX",
                     gcn=learn_method == "sup")
    params = _params(jcfg, ds.num_classes)
    cache_f, cache_c = _jax_cache(ds, pad, "MAX", jax.random.PRNGKey(2))
    rng = np.random.RandomState(1)
    nodes = ds.train_nodes[rng.choice(len(ds.train_nodes), 16,
                                      replace=False)]
    key = jax.random.PRNGKey(3)
    tables = (jnp.asarray(ds.features), cache_f, cache_c,
              jnp.asarray(pad.neighbors), jnp.asarray(pad.degrees))
    if learn_method == "sup":
        batch = nodes.astype(np.int32)
        row_mask = (np.arange(16) < 13).astype(np.float32)
        labels = ds.labels[batch].astype(np.int32)
        step = jax.jit(jc.make_cached_sup_step(jcfg, fanout=FANOUT, lr=0.7))
        want_p, want_loss = step(params, *tables, jnp.asarray(batch),
                                 jnp.asarray(labels), key,
                                 jnp.asarray(row_mask))
        pairs = None
    else:
        pb = JaxPairSampler(ds.graph, ds.train_nodes).sample_batch(
            nodes, num_neg=20, rng=rng)
        batch = pb.unique_nodes.astype(np.int32)
        labels = ds.labels[batch].astype(np.int32)
        row_mask = (np.arange(len(batch)) < pb.num_unique).astype(np.float32)
        step = jax.jit(jc.make_cached_unsup_step(
            jcfg, fanout=FANOUT, lr=0.7, learn_method="plus_unsup"))
        want_p, want_loss = step(params, *tables, jnp.asarray(batch),
                                 jnp.asarray(labels), jax_pair_tensors(pb),
                                 key, jnp.asarray(row_mask))
        pairs = {k: _t(v) for k, v in jax_pair_tensors(pb).items()}
    p = _leaf_params(params, CPU)
    port_step = cached.CachedStep(_port_cfg(jcfg), learn_method=learn_method,
                                  fanout=FANOUT, lr=0.7)
    loss = port_step(p, _t(ds.features), _t(cache_f), _t(cache_c),
                     JaxHop(_hop_keys(key, 1), pad), _t(batch), _t(labels),
                     _t(row_mask), pairs)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    _assert_params_close(p, want_p, atol=1e-5)


def test_epochs_match_jax_and_reuse_equals_fused(graph):
    """A refresh and then the reuse epoch of 4 steps against the JAX
    package's fused epoch with its key tree replayed; the reuse epoch alone
    on the cache the fused epoch drew gives the same losses and params bit
    for bit (staleness changes when the cache refreshes, never the
    step)."""
    ds, pad = graph
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H)
    params = _params(jcfg, ds.num_classes)
    batches = np.random.RandomState(0).randint(0, N, (4, 32)).astype(
        np.int32)
    labels = ds.labels[batches].astype(np.int32)
    key = jax.random.PRNGKey(9)
    fused = jax.jit(jc.make_cached_sup_epoch(jcfg, fanout=FANOUT))
    want_p, want_losses = fused(params, jnp.asarray(ds.features),
                                jnp.asarray(pad.neighbors),
                                jnp.asarray(pad.degrees),
                                jnp.asarray(batches), jnp.asarray(labels),
                                key)
    # the fused program's key tree: k_cache for the refresh, then per step
    # k, sub = split(k) and the step's one hop from split(sub, 1)
    k_cache, k = jax.random.split(key)
    keys = [k_cache]
    for _ in range(4):
        k, sub = jax.random.split(k)
        keys += _hop_keys(sub, 1)

    step = cached.CachedStep(_port_cfg(jcfg), fanout=FANOUT)
    p_a = _leaf_params(params, CPU)
    hop = JaxHop(keys, pad)
    losses_a = cached.cached_epoch_reuse(
        step, p_a, _t(ds.features),
        *cached.refresh_leaf_cache(hop, _t(ds.features), FANOUT), hop,
        _t(batches), _t(labels))
    np.testing.assert_allclose(losses_a.numpy(), np.asarray(want_losses),
                               rtol=1e-4)
    _assert_params_close(p_a, want_p, atol=1e-4)

    hop = JaxHop(keys, pad)
    cache = cached.refresh_leaf_cache(hop, _t(ds.features), FANOUT)
    p_b = _leaf_params(params, CPU)
    losses_b = cached.cached_epoch_reuse(step, p_b, _t(ds.features), *cache,
                                         hop, _t(batches), _t(labels))
    assert torch.equal(losses_a, losses_b)
    for a, b in zip(jax.tree_util.tree_leaves(p_a),
                    jax.tree_util.tree_leaves(p_b)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ trainer

@pytest.fixture(scope="module")
def small_ds():
    return synthetic_power_law(200, 900, num_feats=12, num_classes=3, seed=1)


def test_refresh_every_schedule(small_ds):
    """refresh_every=3: the held cache is reused on epochs 1-2 and
    refreshed on 0 and 3."""
    mcfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8)
    tcfg = TrainConfig(epochs=4, b_sz=32, fanout=4, seed=2, verbose=False,
                       refresh_every=3)
    tr = CachedTrainer(small_ds, mcfg, tcfg, extend_batches=False,
                       device="cpu")
    cache_ids = []
    for ep in range(4):
        tr.epoch = ep
        tr.train_epoch()
        cache_ids.append(id(tr._stale_cache[0]))
        tr.evaluate()
    assert cache_ids[0] == cache_ids[1] == cache_ids[2] != cache_ids[3]
    assert 0.0 <= tr.max_vali_f1 <= 1.0


@pytest.mark.parametrize("agg,extend", [("MEAN", True), ("MAX", False)])
def test_cached_trainer_learns_on_the_cpu(small_ds, agg, extend, capsys,
                                          monkeypatch):
    """Over six epochs of fit the epoch's mean loss falls by a third or
    more, and the best val F1 beats predicting the val split's most common
    class by 0.1.  (MAX with gcn hardly learns on this graph in the JAX
    package either; test_cached_trainer_replays_the_jax_trainer holds it to
    the JAX trainer.)"""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    mcfg = GraphSageConfig(num_layers=2, input_size=12, out_size=16,
                           agg_func=agg)
    tcfg = TrainConfig(learn_method="sup", epochs=6, b_sz=16, fanout=4,
                       lr=0.3, seed=0, emb_b_sz=64)
    tr = CachedTrainer(small_ds, mcfg, tcfg, table_cap=8,
                       extend_batches=extend, device="cpu")
    tr.fit()
    out = capsys.readouterr().out
    assert "Validation F1" in out
    losses = [float(x) for x in re.findall(r"mean loss ([0-9.]+)", out)]
    assert len(losses) == 6 and len(tr.history) == 6
    print(f"epoch losses {losses}; val F1 {tr.max_vali_f1}")
    assert np.isfinite(tr.step_losses).all()
    assert losses[-1] < 0.67 * losses[0], losses
    val_labels = small_ds.labels[small_ds.val_nodes]
    chance = np.bincount(val_labels).max() / len(val_labels)
    assert tr.max_vali_f1 > chance + 0.1, (tr.max_vali_f1, chance)
    emb = tr.all_embeddings()
    assert emb.shape == (200, 16) and np.isfinite(emb).all()


@pytest.mark.parametrize("learn_method,extend", [("sup", False),
                                                 ("plus_unsup", True)])
def test_train_epoch_batches_equal_the_jax_trainers(small_ds, learn_method,
                                                    extend, monkeypatch):
    """CachedTrainer.train_epoch hands its epoch the same host batches as
    the JAX package's CachedTrainer from the same seed, over two epochs:
    the permutation, the wrap-padded tail and its row mask for plain
    batches; the extended batches bucketed to one U, labels, row masks and
    the pair stack of _stack_pair_batches otherwise.  Both start from the
    same RandomState and the same table_cap adjacency."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    from graphsage_tpu.train import cached_trainer as jct
    from graphsage_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from graphsage_torch.train import cached_trainer as pct

    jds = jax_power_law(200, 900, num_feats=12, num_classes=3, seed=1)
    np.testing.assert_array_equal(jds.features, small_ds.features)
    kw = dict(learn_method=learn_method, epochs=2, b_sz=24, fanout=4,
              seed=5, verbose=False)
    jtr = jct.CachedTrainer(jds, JaxConfig(num_layers=2, input_size=12,
                                           out_size=8),
                            JaxTrainConfig(**kw), table_cap=8,
                            extend_batches=extend)
    tr = CachedTrainer(small_ds, GraphSageConfig(num_layers=2, input_size=12,
                                                 out_size=8),
                       TrainConfig(**kw), table_cap=8, extend_batches=extend,
                       device="cpu")
    np.testing.assert_array_equal(tr.neighbors.numpy(), jtr.neighbors)
    np.testing.assert_array_equal(tr.degrees.numpy(), jtr.degrees)
    seen = {}

    def jax_epoch(params, feats, neighbors, degrees, batches, labels, *rest):
        if learn_method == "sup":
            row_masks, pairs = rest[1], None
        else:
            pairs, row_masks = rest[0], rest[1]
        seen["jax"] = (batches, labels, row_masks, pairs)
        return params, jnp.zeros(batches.shape[0])

    def port_epoch(step, params, feats, cache_feats, cache_count, hop,
                   batches, labels, row_masks, pairs):
        seen["port"] = (batches, labels, row_masks, pairs)
        return torch.zeros(batches.shape[0])

    jtr._epoch_fn = jax_epoch
    monkeypatch.setattr(pct, "cached_epoch_reuse", port_epoch)
    for ep in range(2):
        jtr.epoch = tr.epoch = ep
        jtr.train_epoch()
        tr.train_epoch()
        (jb, jl, jm, jp), (pb, pl, pm, pp) = seen["jax"], seen["port"]
        for got, want in ((pb, jb), (pl, jl), (pm, jm)):
            assert got.dtype == {np.dtype("int32"): torch.int32,
                                 np.dtype("float32"): torch.float32}[
                                     np.asarray(want).dtype]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if extend:
            assert pb.shape[1] > kw["b_sz"] and jp.keys() == pp.keys()
            for f in jp:
                np.testing.assert_array_equal(pp[f].numpy(),
                                              np.asarray(jp[f]))
        else:
            assert pb.shape == (-(-len(small_ds.train_nodes) // 24), 24)
            assert jp is None and pp is None


def replay_jax_trainer(jds, ds, jcfg, kw: dict, table_cap: int,
                       lstm_hybrid: bool = False):
    """Train the JAX package's CachedTrainer (plain sup batches) with
    ``fit``, recording every key its refreshes and hops draw with, in call
    order; then the port's CachedTrainer from the same initial params and
    seed, its hop sampler replaying those keys.  Returns
    (jax_trainer, port_trainer, jax step losses, port step losses)."""
    from graphsage_tpu.train import cached_trainer as jct
    from graphsage_tpu.train.trainer import TrainConfig as JaxTrainConfig

    jtr = jct.CachedTrainer(jds, jcfg, JaxTrainConfig(**kw),
                            table_cap=table_cap, extend_batches=False,
                            lstm_hybrid=lstm_hybrid)
    init = jax.device_get(jtr.params)
    hops = jcfg.num_layers - 1
    keys, jax_losses = [], []
    epoch_fn, refresh_fn, fwd_fn = jtr._epoch_fn, jtr._refresh_fn, jtr._fwd_fn

    def epoch(params, feats, neighbors, degrees, batches, labels, key,
              row_masks):
        # make_cached_sup_epoch's key tree: the refresh, then per step
        # k, sub = split(k) and the step's hops from split(sub, hops)
        k_cache, k = jax.random.split(key)
        keys.append(k_cache)
        for _ in range(batches.shape[0]):
            k, sub = jax.random.split(k)
            keys.extend(_hop_keys(sub, hops))
        params, losses = epoch_fn(params, feats, neighbors, degrees, batches,
                                  labels, key, row_masks)
        jax_losses.extend(np.asarray(losses).tolist())
        return params, losses

    def refresh(key, *args):
        keys.append(key)
        return refresh_fn(key, *args)

    def fwd(params, feats, cache_feats, cache_count, neighbors, degrees,
            batch, key):
        keys.extend(_hop_keys(key, hops))
        return fwd_fn(params, feats, cache_feats, cache_count, neighbors,
                      degrees, batch, key)

    jtr._epoch_fn, jtr._refresh_fn, jtr._fwd_fn = epoch, refresh, fwd
    jtr.fit()
    jtr.init_params = init

    tr = CachedTrainer(ds, _port_cfg(jcfg), TrainConfig(**kw),
                       table_cap=table_cap, extend_batches=False,
                       lstm_hybrid=lstm_hybrid, params=init, device="cpu")
    np.testing.assert_array_equal(tr.neighbors.numpy(), jtr.neighbors)
    tr.hop = JaxHop(keys, jtr)
    losses = []
    for ep in range(kw["epochs"]):          # Trainer.fit's sup loop
        tr.epoch = ep
        tr.train_epoch()
        losses.extend(tr.step_losses)
        tr.evaluate()
    assert not tr.hop.keys
    return jtr, tr, np.asarray(jax_losses), np.asarray(losses)


def test_cached_trainer_replays_the_jax_trainer(graph):
    """sup MAX gcn on plain batches at lr 0.7, two epochs of fit: with the
    JAX trainer's draws replayed, the port's step losses (rtol 1e-4), final
    params (atol 1e-4) and val F1 history equal the JAX trainer's."""
    ds, _ = graph
    port_ds = synthetic_power_law(N, 5 * N, num_feats=D, num_classes=4,
                                  seed=4)
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H, agg_func="MAX",
                     gcn=True)
    kw = dict(learn_method="sup", epochs=2, b_sz=32, fanout=FANOUT, lr=0.7,
              seed=3, verbose=False)
    jtr, tr, jax_losses, losses = replay_jax_trainer(ds, port_ds, jcfg, kw,
                                                     table_cap=8)
    assert len(losses) == 2 * -(-len(ds.train_nodes) // 32)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    _assert_params_close(tr.params, jax.device_get(jtr.params), atol=1e-4)
    assert tr.history == jtr.history


def test_cached_lstm_hybrid_replays_the_jax_trainer(graph):
    """The cached-LSTM hybrid (sup, plain batches, lr 0.7, two epochs of
    fit): with the JAX trainer's draws replayed, the port's step losses
    (rtol 1e-4), final params (atol 1e-4) and val F1 history equal the JAX
    trainer's, and both leave the layer-0 cell as it was drawn."""
    ds, _ = graph
    port_ds = synthetic_power_law(N, 5 * N, num_feats=D, num_classes=4,
                                  seed=4)
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H,
                     agg_func="LSTM")
    kw = dict(learn_method="sup", epochs=2, b_sz=32, fanout=FANOUT, lr=0.7,
              seed=3, verbose=False)
    jtr, tr, jax_losses, losses = replay_jax_trainer(
        ds, port_ds, jcfg, kw, table_cap=8, lstm_hybrid=True)
    assert len(losses) == 2 * -(-len(ds.train_nodes) // 32)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    _assert_params_close(tr.params, jax.device_get(jtr.params), atol=1e-4)
    assert tr.history == jtr.history
    cell0 = jtr.init_params["sage"]["agg"][0]
    for k, v in cell0.items():
        np.testing.assert_array_equal(
            tr.params["sage"]["agg"][0][k].detach().numpy(), v)
        np.testing.assert_array_equal(
            np.asarray(jtr.params["sage"]["agg"][0][k]), v)
    assert not np.array_equal(
        tr.params["sage"]["agg"][1]["w_ih"].detach().numpy(),
        jtr.init_params["sage"]["agg"][1]["w_ih"])


def test_lstm_needs_the_opt_in(small_ds):
    """The exact LSTM aggregator cannot ride the leaf cache: without
    lstm_hybrid the trainer refuses; with it, it trains the hybrid."""
    mcfg = GraphSageConfig(num_layers=2, input_size=12, out_size=12,
                           agg_func="LSTM")
    tcfg = TrainConfig(b_sz=32, epochs=1, fanout=4, verbose=False)
    with pytest.raises(ValueError, match="lstm_hybrid"):
        CachedTrainer(small_ds, mcfg, tcfg, device="cpu")
    tr = CachedTrainer(small_ds, mcfg, tcfg, lstm_hybrid=True,
                       extend_batches=False, device="cpu")
    tr.fit()
    assert np.isfinite(tr.step_losses).all() and len(tr.history) == 1


if __name__ == "__main__":
    # Configuration (b) of chip_smoke.py's phase 7 (sup MAX gcn, hidden 128,
    # fanout 10, plain batches of 512 over the first 5,120 train nodes,
    # lr 0.7, seed 824, table_cap 32, 602 features, 16 classes) on a graph
    # cut to --nodes nodes and 10 edges a node, through both trainers with
    # the JAX draws replayed:
    #   python tests/test_torch_cached.py [--nodes 20000]
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--epochs", type=int, default=1)
    args = ap.parse_args()
    n = args.nodes
    jds = jax_power_law(n, 10 * n, num_feats=602, num_classes=16, seed=0)
    ds = synthetic_power_law(n, 10 * n, num_feats=602, num_classes=16, seed=0)
    jds = dataclasses.replace(jds, train_nodes=jds.train_nodes[:5120])
    ds = dataclasses.replace(ds, train_nodes=ds.train_nodes[:5120])
    jtr, tr, jax_losses, losses = replay_jax_trainer(
        jds, ds, JaxConfig(num_layers=2, input_size=602, out_size=128,
                           agg_func="MAX", gcn=True),
        dict(learn_method="sup", epochs=args.epochs, b_sz=512, fanout=10,
             lr=0.7, seed=824, verbose=False), table_cap=32)
    print(json.dumps({
        "nodes": n, "jax_losses": jax_losses.tolist(),
        "port_losses": losses.tolist(),
        "max_rel_diff": float(np.max(np.abs(losses - jax_losses)
                                     / np.abs(jax_losses))),
        "jax_history": jtr.history, "port_history": tr.history}))
