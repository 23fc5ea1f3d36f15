"""bfloat16 training in the port against the JAX package's bfloat16 paths, on
the CPU: the dense pipeline, the compact ``Trainer``, the leaf-cached
pipeline, and the CLI with its exported bundle.

The contract (``train.dense.cast_compute``): master params stay float32 and
are rounded to bfloat16 inside the loss, the feature table (and the leaf
cache) is held in bfloat16, products accumulate in float32, and the losses
reduce in float32.  Both packages round at the same points, but XLA on the
CPU may keep a chain of bfloat16 elementwise ops in float32, and the sums
run in other orders, so the comparisons are at bfloat16 tolerances:

- forward embeddings: |port - jax| <= 2 bf16 ulps of the JAX value + 4e-3
  (8e-3 for the compact all-LSTM model: two bf16 LSTM layers of 11 scan
  steps each, and an output near 0 that cancels O(1) terms; measured, one
  of 320 values 5.1e-3 from JAX's, where the port lies 1.9e-3 from the
  float32 value and JAX 3.2e-3, both 9.6e-4 away on average);
- one step from the same params and draws: loss rtol 1e-2, and each param
  leaf's update within 2e-2 of the largest element of JAX's update of that
  leaf;
- the port's bfloat16 loss within 0.02 of its own float32 loss (the bar
  tests/test_bf16.py sets the JAX package).

Each test prints the largest errors it saw (``pytest -s``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models.layers import init_classifier as jax_init_clf
from graphsage_tpu.train import Trainer as JaxTrainer
from graphsage_tpu.train import TrainConfig as JaxTrainConfig
from graphsage_tpu.train import cached as jc
from graphsage_tpu.train import dense as jd
from graphsage_torch import cli, infer
from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import Trainer, TrainConfig, cached, dense
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_cached import JaxHop, _hop_keys, _t

N, D, H, C, FANOUT = 300, 16, 16, 4, 4
CPU = torch.device("cpu")
EMB_ATOL, LOSS_RTOL, UPDATE_RTOL = 4e-3, 1e-2, 2e-2


@pytest.fixture(scope="module")
def graph():
    ds = jax_power_law(N, 5 * N, num_feats=D, num_classes=C, seed=4)
    return ds, ds.graph.to_padded(cap=16)


def _jcfg(dtype="bfloat16", **kw):
    return JaxConfig(num_layers=2, input_size=D, out_size=H,
                     compute_dtype=dtype, **kw)


def _port_cfg(jcfg):
    return GraphSageConfig(**dataclasses.asdict(jcfg))


def _params(jcfg):
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    return jax.device_get({"sage": jax_init_graphsage(k1, jcfg),
                           "clf": jax_init_clf(k2, jcfg.out_size, C)})


def _bf16_tables(ds, pad):
    return (jnp.asarray(ds.features, dtype=jnp.bfloat16),
            jnp.asarray(pad.neighbors), jnp.asarray(pad.degrees))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_emb_close(what, got, want, atol=EMB_ATOL) -> float:
    """Within 2 bf16 ulps of the JAX value plus ``atol``; returns the
    largest error."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))
                  - 7)
    err = np.abs(got - want)
    assert (err <= 2 * ulp + atol).all(), (what, float(err.max()))
    print(f"{what}: embeddings max abs error {err.max():.3e}")
    return float(err.max())


def assert_step_close(what, loss, want_loss, before, after, want_after):
    """Loss within LOSS_RTOL; each leaf's update within UPDATE_RTOL of the
    largest element of JAX's update of that leaf."""
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    worst = 0.0
    leaves = zip(jax.tree_util.tree_leaves(before),
                 jax.tree_util.tree_leaves(after),
                 jax.tree_util.tree_leaves(want_after))
    for b, a, w in leaves:
        assert _np(a).dtype == np.float32
        got_upd = _np(a) - _np(b)
        want_upd = _np(w) - _np(b)
        scale = np.abs(want_upd).max()
        err = np.abs(got_upd - want_upd).max()
        assert err <= UPDATE_RTOL * scale, (what, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    print(f"{what}: loss relative error {rel:.3e}; largest update error "
          f"{worst:.3e} of the leaf's largest update")


# ------------------------------------------------------------ dense

def test_cast_compute_keeps_f32_master_params_and_loss(graph):
    """A bf16 dense step against the port's own f32 step from the same
    params and draws: master params and the loss stay float32, the
    embeddings are bfloat16, and the losses lie within 0.02."""
    ds, pad = graph
    batch = np.arange(48, dtype=np.int32)
    labels = ds.labels[batch].astype(np.int32)
    params = _params(_jcfg("float32"))
    key = jax.random.PRNGKey(9)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _port_cfg(_jcfg(dtype))
        p = _leaf_params(params, CPU)
        with torch.no_grad():
            embs = dense.dense_forward(p, cfg, _t(ds.features),
                                       JaxHop(jax.random.split(key, 2), pad),
                                       _t(batch), FANOUT)
        assert embs.dtype == getattr(torch, dtype)
        cast = dense.cast_compute(p, cfg)
        assert all(x.dtype == getattr(torch, dtype)
                   for x in jax.tree_util.tree_leaves(cast))
        loss = dense.make_dense_sup_step(cfg, fanout=FANOUT)(
            p, _t(ds.features), JaxHop(jax.random.split(key, 2), pad),
            _t(batch), _t(labels))
        assert loss.dtype == torch.float32
        assert all(x.dtype == torch.float32 and x.requires_grad
                   for x in jax.tree_util.tree_leaves(p))
        losses[dtype] = float(loss)
    gap = abs(losses["bfloat16"] - losses["float32"])
    print(f"bf16 loss {losses['bfloat16']:.6f} vs f32 "
          f"{losses['float32']:.6f}: gap {gap:.3e}")
    assert gap < 0.02 * max(1.0, abs(losses["float32"]))


def test_dense_bf16_step_matches_jax(graph):
    ds, pad = graph
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    params = _params(jcfg)
    batch = ds.train_nodes[:32].astype(np.int32)
    labels = ds.labels[batch].astype(np.int32)
    key = jax.random.PRNGKey(5)
    tables = _bf16_tables(ds, pad)
    want = jax.jit(jd.dense_forward, static_argnums=(1, 7))(
        params, jcfg, *tables, jnp.asarray(batch), key, FANOUT)
    with torch.no_grad():
        got = dense.dense_forward(params_from_jax(params), cfg,
                                  _t(ds.features),
                                  JaxHop(jax.random.split(key, 2), pad),
                                  _t(batch), FANOUT)
    assert got.dtype == torch.bfloat16
    assert_emb_close("dense forward", got, want)
    want_p, want_loss = jax.jit(jd.make_dense_sup_step(
        jcfg, fanout=FANOUT, lr=0.7))(params, *tables, jnp.asarray(batch),
                                      jnp.asarray(labels), key)
    p = _leaf_params(params, CPU)
    feats = _t(ds.features).bfloat16()
    loss = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=0.7)(
        p, feats, JaxHop(jax.random.split(key, 2), pad), _t(batch),
        _t(labels))
    assert loss.dtype == torch.float32
    assert_step_close("dense sup step", loss, want_loss, params, p, want_p)


# ------------------------------------------------------------ compact

@pytest.fixture(scope="module")
def datasets():
    """The same 300-node graph from both packages, the train split cut to
    one batch of 20."""
    jds = jax_power_law(N, 5 * N, num_feats=D, seed=1)
    ds = synthetic_power_law(N, 5 * N, num_feats=D, seed=1)
    return (dataclasses.replace(ds, train_nodes=ds.train_nodes[:20]),
            dataclasses.replace(jds, train_nodes=jds.train_nodes[:20]))


@pytest.mark.parametrize("learn_method,agg_func,gcn", [
    ("sup", "MEAN", False), ("plus_unsup", "MEAN", False),
    ("sup", "MAX", True), ("plus_unsup", "LSTM", False)])
def test_compact_trainer_bf16_matches_jax(datasets, learn_method, agg_func,
                                          gcn, monkeypatch):
    """The compact Trainer in bf16 against the JAX Trainer in bf16: the
    embeddings of 20 val nodes (the same host frontiers), then one training
    step from the same params and batch."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, jds = datasets
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=H, gcn=gcn,
                     agg_func=agg_func, compute_dtype="bfloat16")
    kw = dict(epochs=1, b_sz=20, seed=5, verbose=False,
              learn_method=learn_method)
    jtr = JaxTrainer(jds, jcfg, JaxTrainConfig(**kw))
    params0 = jax.device_get(jtr.params)
    tr = Trainer(ds, _port_cfg(jcfg), TrainConfig(**kw), params=params0,
                 device="cpu")
    assert tr.feats.dtype == torch.bfloat16
    nodes = ds.val_nodes[:20]
    got = tr.embed_nodes(nodes)
    assert got.dtype == np.float32
    assert_emb_close(f"compact {learn_method} {agg_func} forward", got,
                     jtr.embed_nodes(nodes),
                     atol=2 * EMB_ATOL if agg_func == "LSTM" else EMB_ATOL)
    losses = []
    step = jtr._step_fn

    def recording(*args):
        out = step(*args)
        losses.append(float(out[1]))
        return out

    jtr._step_fn = recording
    jtr.train_epoch()
    tr.train_epoch()
    assert len(losses) == len(tr.step_losses) == 1
    assert_step_close(f"compact {learn_method} {agg_func} step",
                      tr.step_losses[0], losses[0], params0, tr.params,
                      jax.device_get(jtr.params))
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)


# ------------------------------------------------------------ cached

@pytest.mark.parametrize("agg,gcn,b", [
    ("MEAN", False, 8), ("MEAN", False, 32), ("MAX", True, 32),
    ("LSTM", False, 32)],
    ids=["MEAN-per_occurrence", "MEAN-full_table", "MAX-gcn-full_table",
         "LSTM-hybrid"])
def test_cached_bf16_step_matches_jax(graph, agg, gcn, b):
    """The bf16 refresh on JAX's draws, the cached forward (both layer-1
    branches, by the batch size), and one sup step, against the JAX
    package's bf16 functions."""
    ds, pad = graph
    jcfg = _jcfg(agg_func=agg, gcn=gcn)
    cfg = _port_cfg(jcfg)
    params = _params(jcfg)
    tables = _bf16_tables(ds, pad)
    k_cache = jax.random.PRNGKey(2)
    want_f, want_c = jax.jit(jc.refresh_leaf_cache, static_argnums=(4, 5))(
        k_cache, *tables, FANOUT, agg)
    feats = _t(ds.features).bfloat16()
    cache_f, cache_c = cached.refresh_leaf_cache(
        JaxHop([k_cache], pad), feats, FANOUT, agg=agg)
    assert cache_f.dtype == torch.bfloat16
    assert_emb_close(f"cached {agg} refresh", cache_f, want_f)
    np.testing.assert_array_equal(_np(cache_c), _np(want_c))

    rng = np.random.RandomState(1)
    batch = ds.train_nodes[rng.choice(len(ds.train_nodes), b,
                                      replace=False)].astype(np.int32)
    labels = ds.labels[batch].astype(np.int32)
    row_mask = (np.arange(b) < b - 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jtabs = (tables[0], want_f, want_c, tables[1], tables[2])
    want = jax.jit(jc.cached_forward, static_argnums=(1, 9))(
        params, jcfg, *jtabs, jnp.asarray(batch), key, FANOUT)
    ids, frontiers = cached.sample_cached_frontiers(
        JaxHop(_hop_keys(key, 1), pad), _t(batch), cfg, FANOUT)
    with torch.no_grad():
        got = cached.cached_forward(params_from_jax(params), cfg, feats,
                                    cache_f, cache_c, ids, frontiers, FANOUT)
    assert got.dtype == torch.bfloat16
    assert_emb_close(f"cached {agg} b{b} forward", got, want)

    step = jax.jit(jc.make_cached_sup_step(jcfg, fanout=FANOUT, lr=0.7))
    want_p, want_loss = step(params, *jtabs, jnp.asarray(batch),
                             jnp.asarray(labels), key, jnp.asarray(row_mask))
    p = _leaf_params(params, CPU)
    loss = cached.CachedStep(cfg, fanout=FANOUT, lr=0.7)(
        p, feats, cache_f, cache_c, JaxHop(_hop_keys(key, 1), pad),
        _t(batch), _t(labels), _t(row_mask))
    assert loss.dtype == torch.float32
    assert_step_close(f"cached {agg} b{b} step", loss, want_loss, params, p,
                      want_p)


# ------------------------------------------------------------ CLI

@pytest.mark.parametrize("pipeline", ["compact", "cached"])
def test_cli_trains_bf16_exports_and_serves_bf16(pipeline, tmp_path):
    out = str(tmp_path / "bundle")
    argv = ["--dataSet", "powerlaw:300:1200", "--epochs", "1", "--b_sz",
            "50", "--hidden", "16", "--device", "cpu", "--export", out,
            "--seed", "3", "--compute_dtype", "bfloat16", "--quiet",
            "--checkpoint_dir", str(tmp_path / "ck")]
    if pipeline == "cached":
        argv += ["--pipeline", "cached", "--table_cap", "8"]
    trainer, _ = cli.run(argv)
    assert trainer.feats.dtype == torch.bfloat16
    assert all(x.dtype == torch.float32
               for x in jax.tree_util.tree_leaves(trainer.params))
    assert np.isfinite(trainer.step_losses).all()
    params, mcfg, _, _ = infer.load_bundle(out)
    assert mcfg.compute_dtype == "bfloat16"
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    table = sess.embeddings()
    # served in bfloat16: every value is a bfloat16 number
    t = torch.from_numpy(table)
    assert torch.equal(t.bfloat16().float(), t) and t.abs().sum() > 0
    want = infer.full_graph_embeddings(params["sage"], mcfg,
                                       trainer.ds.features, pad,
                                       device="cpu")
    np.testing.assert_array_equal(table, want)
    assert sess.predict(trainer.ds.val_nodes).shape == (
        len(trainer.ds.val_nodes),)


# ------------------------------------------------------------ the scatter

HUB = dict(u=1500, s=11, m=300, d=64)


def _hub_inputs(seed):
    """Slots 0-6 of every row point at row 0 (about 7,350 contributions
    under the 70% mask), as the card tests' hub case."""
    rng = np.random.RandomState(seed)
    embed = rng.randn(HUB["m"], HUB["d"]).astype(np.float32)
    idx = rng.randint(0, HUB["m"], (HUB["u"], HUB["s"])).astype(np.int32)
    idx[:, :7] = 0
    mask = (rng.rand(HUB["u"], HUB["s"]) < 0.7).astype(np.float32)
    g = rng.randn(HUB["u"], HUB["d"]).astype(np.float32)
    return embed, idx, mask, g


def _sequential_bf16(terms, rows, row):
    """Row ``row`` of the scatter as a loop: the contributions added one at
    a time in index order, each add rounded to bfloat16 (numpy's bfloat16,
    ml_dtypes)."""
    acc = np.zeros(terms.shape[1], dtype=jnp.bfloat16)
    for j in np.flatnonzero(rows == row):
        acc = (acc.astype(np.float32) + terms[j].astype(np.float32)
               ).astype(jnp.bfloat16)
    return acc.astype(np.float32)


def test_bf16_scatter_equals_jax_past_the_long_row_window():
    """``tests/test_torch_kernels.py``'s over_window case: a row of about
    1,700 contributions spread over more place blocks than the kernel's
    long-row sort window (``scatter.LONG_SMEM / 8`` blocks of 256), at width
    1, among 1,576,960 mostly all-zero contributions.  ``jnp.take``'s VJP
    in the JAX package equals the port's plain scatter bit for bit there;
    the card's kernel is held to the plain version on that case in the card
    tests."""
    from graphsage_torch.ops.scatter import scatter_rows_plain
    from tests.test_torch_kernels import _scatter_rows_case

    g, idx, m = _scatter_rows_case("over_window")
    got = scatter_rows_plain(g, idx, m)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx.numpy()), axis=0),
                     jnp.zeros((m, 1), dtype=jnp.bfloat16))
    want, = vjp(jnp.asarray(g.float().numpy(), dtype=jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert int((idx == 0).sum()) > 256


@pytest.mark.parametrize("kind", ["mean", "max", "rows"])
def test_bf16_scatter_equals_jax_on_the_hub_case(kind):
    """The bfloat16 backward of the masked mean (``_pallas_mean_bwd``), the
    masked max (``_pallas_max_bwd``) and the row gather (``jnp.take``'s
    VJP) in the JAX package against the port's (``mean_aggregate_backward``,
    ``max_aggregate_backward``, ``GatherRows``' ``scatter_rows``) on the
    same inputs: equal bit for bit, on a row of about 7,350 contributions.
    The witness of JAX's semantics: its hub row equals the contributions
    added one at a time in index order in bfloat16, and so lies far from
    their float64 sum (printed); the card's kernel is held to the port's
    plain version bit for bit (tests/test_torch_kernels.py)."""
    from graphsage_tpu.ops.pallas_aggregate import (_pallas_max_bwd,
                                                    _pallas_mean_bwd)
    from graphsage_torch.ops import aggregate as agg
    from graphsage_torch.ops.gather import gather_rows

    embed, idx, mask, g = _hub_inputs(seed=7)
    if kind == "max":
        embed[1::3] = embed[0::3][:len(embed[1::3])]   # 2- and 3-way ties
    e16 = torch.from_numpy(embed).bfloat16()
    je = jnp.asarray(embed, dtype=jnp.bfloat16)
    if kind == "rows":
        flat = idx.reshape(-1)
        g = np.random.RandomState(8).randn(flat.size, HUB["d"]).astype(
            np.float32)
        g16 = torch.from_numpy(g).bfloat16()
        leaf = e16.clone().requires_grad_(True)
        gather_rows(leaf, torch.from_numpy(flat)).backward(g16)
        got = leaf.grad
        _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(flat), axis=0),
                         je)
        want, = vjp(jnp.asarray(g, dtype=jnp.bfloat16))
        terms, rows = np.asarray(jnp.asarray(g, dtype=jnp.bfloat16)), flat
    else:
        g16 = torch.from_numpy(g).bfloat16()
        i, m = torch.from_numpy(idx), torch.from_numpy(mask)
        jg = jnp.asarray(g, dtype=jnp.bfloat16)
        res = (je, jnp.asarray(idx), jnp.asarray(mask))
        if kind == "mean":
            got = agg.mean_aggregate_backward(g16, i, m, e16.shape,
                                              torch.bfloat16)
            want, _, _ = _pallas_mean_bwd(True, None, res, jg)
            w = (mask / np.maximum(mask.sum(1, keepdims=True), 1.0))
            w16 = np.asarray(jnp.asarray(w, dtype=jnp.bfloat16))
            terms = (np.asarray(jg)[:, None, :].astype(np.float32)
                     * w16[:, :, None].astype(np.float32))
        else:
            out = agg.max_aggregate_plain(e16, i, m)
            got = agg.max_aggregate_backward(g16, e16, i, m, out)
            jout = jnp.asarray(out.float().numpy(), dtype=jnp.bfloat16)
            want, _, _ = _pallas_max_bwd(True, None, (*res, jout), jg)
            gathered = np.asarray(je)[idx]
            is_max = ((gathered == np.asarray(jout)[:, None, :])
                      & (mask[..., None] > 0)).astype(np.float32)
            denom = np.maximum(is_max.sum(1, keepdims=True), 1.0)
            terms = (np.asarray(jg).astype(np.float32)[:, None, :]
                     * is_max / denom)
        terms = terms.astype(jnp.bfloat16).reshape(-1, HUB["d"])
        rows = idx.reshape(-1)
    want = np.asarray(want).astype(np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    nonzero = (terms.astype(np.float32) != 0).any(axis=1)
    hub = int(np.bincount(rows[nonzero], minlength=HUB["m"]).argmax())
    np.testing.assert_array_equal(want[hub],
                                  _sequential_bf16(terms, rows, hub))
    exact = np.zeros((HUB["m"], HUB["d"]))
    np.add.at(exact, rows, terms.astype(np.float64))
    dev = np.abs(want[hub] - exact[hub]).max() / np.abs(exact[hub]).max()
    n = int(np.bincount(rows[nonzero])[hub])
    print(f"{kind} bf16 scatter: the port equals JAX bit for bit; JAX's "
          f"hub row ({n} nonzero contributions) equals the sequential "
          f"bfloat16 sum and lies {dev:.3e} of its largest |sum| from the "
          f"float64 sum")
