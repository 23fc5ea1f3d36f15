"""The port's training path (graphsage_torch.models.graphsage,
.ops.aggregate's gather-mean backward, .train, .cli) against the JAX
package's, on the CPU, from the same numpy inputs, the same sampled
frontiers and the same initial weights (carried over with params_from_jax).

Tolerances:
- encoder forward and parameter gradients: rtol 1e-5, atol 1e-6 (float32,
  the same sums and products in another order);
- gather-mean backward: rtol=atol=1e-6 (one product and a sum per slot);
- one training epoch (10 steps, lr 0.7): step losses rtol 1e-4, final
  params atol 2e-4.  Both trainers see bit-identical batches; the
  differences are float32 roundings of the same arithmetic taken in
  another order, carried through the SGD updates.  Measured on this CPU:
  at most 3.2e-6 relative on a loss and 1.2e-5 on a weight (of ~0.75).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import graphsage as jax_graphsage
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.ops.pallas_aggregate import _pallas_mean_bwd
from graphsage_tpu.sampler import build_compact_batch as jax_build
from graphsage_tpu.train import Trainer as JaxTrainer
from graphsage_tpu.train import TrainConfig as JaxTrainConfig
from graphsage_tpu.train.optim import clip_by_global_norm as jax_clip
from graphsage_torch import cli, infer
from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig, graphsage
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.train import Trainer, TrainConfig
from graphsage_torch.train.optim import clip_by_global_norm, sgd_update
from graphsage_torch.train.trainer import _frontiers, _leaf_params
from tests.test_torch_aggregate import _case

ENC = dict(rtol=1e-5, atol=1e-6)


def _port_cfg(jcfg):
    return GraphSageConfig(**dataclasses.asdict(jcfg))


# ------------------------------------------------------------ encoder

@pytest.mark.parametrize("layout", [
    dict(n=300, mean_pretransform="auto"),            # table transformed
    dict(n=3000, mean_pretransform="auto"),           # layer rule decides
    dict(n=300, mean_pretransform="never"),           # no pretransform
    dict(n=300, mean_pretransform="always", gcn=True),
    dict(n=300, mean_pretransform="auto", impl="pallas"),
], ids=["apply_table", "layer_rule", "never", "always_gcn", "pallas_opt_out"])
def test_encoder_forward_and_grads_match_jax(layout):
    layout = dict(layout)
    n = layout.pop("n")
    ds = jax_power_law(n, 5 * n, num_feats=48, seed=3)
    jcfg = JaxConfig(num_layers=2, input_size=48, out_size=8, **layout)
    params = jax.device_get(jax_init_graphsage(jax.random.PRNGKey(1), jcfg))
    batch = np.random.RandomState(2).choice(n, 40, replace=False)
    cb = jax_build(ds.graph, batch, np.random.RandomState(3), num_layers=2,
                   fanout=5, gcn=jcfg.gcn)
    x0 = cb.x0_ids
    table_rule = n <= 2 * len(x0)
    assert table_rule == (n == 300)
    w_out = np.random.RandomState(4).randn(cb.out_rows, 8).astype(np.float32)

    def jax_loss(p):
        out = jax_graphsage.graphsage_apply_gathered(
            p, jcfg, jnp.asarray(ds.features), jnp.asarray(x0),
            [jax_graphsage.Frontier(*map(jnp.asarray, (f.idx, f.mask,
                                                       f.self_idx)))
             for f in cb.frontiers])
        return jnp.sum(jnp.sin(out) * w_out), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        params)
    p = {"layers": [{"weight": torch.from_numpy(np.array(l["weight"]))
                     .requires_grad_(True)} for l in params["layers"]]}
    got = graphsage.graphsage_apply_gathered(
        p, _port_cfg(jcfg), torch.from_numpy(ds.features),
        torch.from_numpy(x0), _frontiers(cb, torch.device("cpu")))
    (torch.sin(got) * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ENC)
    for layer, jlayer in zip(p["layers"], want_grads["layers"]):
        np.testing.assert_allclose(layer["weight"].grad.numpy(),
                                   np.asarray(jlayer["weight"]), **ENC)


def test_use_pretransform_rule_matches_jax():
    rng = np.random.RandomState(0)
    for m, u, d, mode, impl in [(100, 50, 8, "auto", "xla"),
                                (101, 50, 8, "auto", "xla"),
                                (199, 50, 64, "auto", "xla"),
                                (201, 50, 64, "auto", "xla"),
                                (500, 10, 8, "always", "xla"),
                                (10, 50, 8, "never", "xla"),
                                (10, 50, 8, "auto", "pallas")]:
        jcfg = JaxConfig(num_layers=2, input_size=d, out_size=16,
                         mean_pretransform=mode, impl=impl)
        h = rng.randn(m, d).astype(np.float32)
        idx = np.zeros((u, 3), np.int32)
        f = jax_graphsage.Frontier(idx, idx.astype(np.float32), idx[:, 0])
        assert (graphsage._use_pretransform(_port_cfg(jcfg),
                                            torch.from_numpy(h), f)
                == jax_graphsage._use_pretransform(jcfg, jnp.asarray(h), f))


def test_unported_training_configs_raise():
    ds = synthetic_power_law(100, 400, num_feats=8, seed=0)
    for kw, item in ((dict(agg_func="MAX"), "item 12"),
                     (dict(agg_func="LSTM"), "item 13"),
                     (dict(compute_dtype="bfloat16"), "item 14")):
        cfg = GraphSageConfig(num_layers=2, input_size=8, out_size=4, **kw)
        with pytest.raises(NotImplementedError, match=item):
            Trainer(ds, cfg, TrainConfig(verbose=False), device="cpu")


# ------------------------------------------------------------ gather-mean

@pytest.mark.parametrize("case", ["random", "empty_rows", "unaligned"])
def test_gather_mean_backward_matches_jax(case):
    """The gather-mean Function's gradient against JAX's _pallas_mean_bwd,
    and through a strided view (the pretransform's h_cat[:, H:])."""
    embed, idx, mask = _case(case, seed=5)
    g = np.random.RandomState(6).randn(idx.shape[0],
                                       embed.shape[1]).astype(np.float32)
    want, _, _ = _pallas_mean_bwd(True, "mean", (jnp.asarray(embed),
                                                 jnp.asarray(idx),
                                                 jnp.asarray(mask)),
                                  jnp.asarray(g))
    e = torch.from_numpy(embed).requires_grad_(True)
    (agg.mean_aggregate(e, torch.from_numpy(idx), torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

    wide = torch.from_numpy(np.concatenate([embed, embed], axis=1)
                            ).requires_grad_(True)
    d = embed.shape[1]
    (agg.mean_aggregate(wide[:, d:], torch.from_numpy(idx),
                        torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    assert not wide.grad[:, :d].any()
    np.testing.assert_array_equal(wide.grad[:, d:].numpy(), e.grad.numpy())


def test_max_still_refuses_autograd_only_on_the_card():
    embed, idx, mask = _case("random")
    e = torch.from_numpy(embed).requires_grad_(True)
    out = agg.max_aggregate(e, torch.from_numpy(idx), torch.from_numpy(mask))
    out.sum().backward()          # the plain version on the CPU
    assert e.grad is not None


# ------------------------------------------------------------ optimizer

def test_clip_and_sgd_match_jax():
    rng = np.random.RandomState(1)
    grads = [rng.randn(5, 4).astype(np.float32) * 3,
             rng.randn(7).astype(np.float32)]
    params = [rng.randn(5, 4).astype(np.float32),
              rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 1e4):     # clipped, and left alone
        want = jax_clip([jnp.asarray(x) for x in grads], max_norm)
        got = clip_by_global_norm([torch.from_numpy(x) for x in grads],
                                  max_norm)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    tp = [torch.from_numpy(p.copy()) for p in params]
    sgd_update(tp, [torch.from_numpy(x) for x in grads], 0.7)
    for x, p, g in zip(tp, params, grads):
        np.testing.assert_array_equal(x.numpy(), p - np.float32(0.7) * g)


# ------------------------------------------------------------ trainer

@pytest.fixture(scope="module")
def datasets():
    """synthetic_power_law(2000, 10000, 64 features) from both packages, the
    train split cut to its first 200 nodes (10 steps of 20)."""
    jds = jax_power_law(2000, 10000, num_feats=64, seed=1)
    ds = synthetic_power_law(2000, 10000, num_feats=64, seed=1)
    return (dataclasses.replace(ds, train_nodes=ds.train_nodes[:200]),
            dataclasses.replace(jds, train_nodes=jds.train_nodes[:200]))


def _run_both(datasets, **tcfg):
    ds, jds = datasets
    jm = JaxConfig(num_layers=2, input_size=64, out_size=16)
    jt = JaxTrainConfig(epochs=1, b_sz=20, seed=5, verbose=False, **tcfg)
    jtr = JaxTrainer(jds, jm, jt)
    params0 = jax.device_get(jtr.params)
    jax_losses = []
    step = jtr._step_fn

    def recording_step(*args):
        out = step(*args)
        jax_losses.append(float(out[1]))
        return out

    jtr._step_fn = recording_step
    tr = Trainer(ds, _port_cfg(jm), TrainConfig(epochs=1, b_sz=20, seed=5,
                                                verbose=False, **tcfg),
                 params=params0, device="cpu")
    return jtr, tr, jax_losses


@pytest.mark.parametrize("learn_method,unsup_loss", [
    ("sup", "normal"), ("plus_unsup", "normal"), ("plus_unsup", "margin")])
def test_trainer_matches_jax_step_for_step(datasets, learn_method,
                                           unsup_loss, monkeypatch):
    # uniform negatives: on this small graph every train node lies within
    # 5 hops of every other, so exact mode would find no negatives
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    jtr, tr, jax_losses = _run_both(datasets, learn_method=learn_method,
                                    unsup_loss=unsup_loss)
    want_mean = jtr.train_epoch()
    got_mean = tr.train_epoch()
    assert len(tr.step_losses) == len(jax_losses) == 10
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-4)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-4)
    want = jax.device_get(jtr.params)
    got = jax.tree_util.tree_map(lambda x: x.detach().numpy(), tr.params)
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    # the host RNG streams stayed in step
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)
    jtr.evaluate()
    tr.evaluate()
    assert tr.history[-1]["val_f1"] == pytest.approx(
        jtr.history[-1]["val_f1"], abs=0.01)


def test_unsup_trains_the_classifier_like_jax(datasets, monkeypatch):
    """unsup with clf_epochs=1: the classifier-only fit on frozen
    embeddings.  Unsupervised SGD at lr 0.7 doubles a rounding difference
    about every step (1e-7 at step 2, 1.5e-5 at step 10), so the encoder
    is held for one epoch and then carried over from JAX before the
    classifier phase, which is compared on its own."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    jtr, tr, jax_losses = _run_both(datasets, learn_method="unsup",
                                    clf_epochs=1, emb_b_sz=1000)
    jtr.train_epoch()
    tr.train_epoch()
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-4)
    tr.params["sage"] = _leaf_params(jax.device_get(jtr.params["sage"]),
                                     torch.device("cpu"))
    jtr.epoch = tr.epoch = 1
    assert tr.train_classification() == jtr.train_classification()
    assert tr.history == jtr.history
    want = jax.device_get(jtr.params["clf"])
    for name in ("weight", "bias"):
        np.testing.assert_allclose(tr.params["clf"][name].detach().numpy(),
                                   want[name], rtol=0, atol=1e-5)
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)


def test_unsup_fit_fits_the_classifier_every_second_epoch(datasets,
                                                          monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, _ = datasets
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(learn_method="unsup", epochs=2, b_sz=100,
                             lr=0.1, clf_epochs=2, emb_b_sz=1000,
                             verbose=False), device="cpu")
    tr.fit()
    assert [h["epoch"] for h in tr.history] == [1, 1]


def test_trainer_without_a_card_or_device_raises(datasets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, _ = datasets
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ds, GraphSageConfig(num_layers=2, input_size=64, out_size=8),
                TrainConfig(verbose=False))


def test_params_carried_over_are_copies(datasets):
    ds, _ = datasets
    start = {"sage": {"layers": [{"weight": np.ones((8, 128), np.float32)},
                                 {"weight": np.ones((8, 16), np.float32)}]},
             "clf": {"weight": np.ones((ds.num_classes, 8), np.float32),
                     "bias": np.zeros(ds.num_classes, np.float32)}}
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(verbose=False, b_sz=100), params=start,
                 device="cpu")
    tr.train_epoch()
    assert (start["sage"]["layers"][0]["weight"] == 1).all()
    assert params_from_jax(start)["clf"]["weight"].dtype == torch.float32


# ------------------------------------------------------------ CLI

def test_cli_trains_exports_and_serves(tmp_path, capsys):
    out = str(tmp_path / "bundle")
    argv = ["--dataSet", "powerlaw:300:1200", "--learn_method", "plus_unsup",
            "--epochs", "1", "--b_sz", "50", "--hidden", "16",
            "--device", "cpu", "--export", out, "--seed", "3"]
    assert cli.main(argv) == 0
    assert "Best validation F1" in capsys.readouterr().out
    params, mcfg, ncls, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val" and mcfg.out_size == 16

    trainer, best = cli.run(argv + ["--quiet"])
    again, _, _, _ = infer.load_bundle(out)
    for w, g in zip(jax.tree_util.tree_leaves(best["params"]),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(g, w)     # the best-val snapshot
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features,
                                              trainer.ds.graph.to_padded(),
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features,
                                       trainer.ds.graph.to_padded(),
                                       device="cpu")
    np.testing.assert_allclose(sess.embeddings(), want, rtol=1e-5,
                               atol=1e-5)
    assert sess.predict(trainer.ds.val_nodes).shape == (
        len(trainer.ds.val_nodes),)


@pytest.mark.parametrize("flags,match", [
    (["--pipeline", "cached_dist"], "item 16"),
    (["--pipeline", "dist"], "item 16"),
    (["--resume", "x"], "item 8"),
    (["--agg_func", "MAX"], "item 12"),
    (["--pipeline", "cached", "--agg_func", "LSTM", "--lstm_hybrid"],
     "item 13"),
    (["--pipeline", "cached", "--compute_dtype", "bfloat16"], "item 14"),
])
def test_cli_refuses_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["--dataSet", "powerlaw:100:400", "--device", "cpu",
                  "--epochs", "1", "--quiet", *flags])


def test_cli_cached_pipeline_trains_exports_and_serves(tmp_path,
                                                     monkeypatch):
    """--pipeline cached on the CPU with its flags, then the exported
    bundle served by InferenceSession.from_bundle."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    out = str(tmp_path / "cached")
    trainer, best = cli.run([
        "--dataSet", "powerlaw:300:1200", "--pipeline", "cached",
        "--table_cap", "8", "--refresh_every", "2", "--epochs", "2",
        "--learn_method", "plus_unsup", "--b_sz", "50", "--hidden", "16",
        "--device", "cpu", "--export", out, "--seed", "3", "--quiet"])
    assert type(trainer).__name__ == "CachedTrainer"
    assert trainer.neighbors.shape[1] == 8 and len(trainer.history) == 2
    params, mcfg, _, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val" and mcfg.out_size == 16
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features, pad,
                                       device="cpu")
    np.testing.assert_allclose(sess.embeddings(), want, rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(sess.embeddings()).all()


def test_metrics_sink_records_epochs(datasets, tmp_path):
    ds, _ = datasets
    path = str(tmp_path / "m.jsonl")
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(verbose=False, b_sz=100, epochs=1,
                             metrics_path=path, prefetch_depth=0),
                 device="cpu")
    tr.fit()
    import json
    events = [json.loads(l)["event"] for l in open(path)]
    assert events[0] == "epoch" and "eval" in events
    assert os.path.getsize(path) > 0
