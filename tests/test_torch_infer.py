"""The port's serving path (graphsage_torch.infer) against the JAX package's
(graphsage_tpu.infer), on the CPU, with the same graph, features and
weights: the JAX params are carried over with params_from_jax.

Tolerance: float32 rtol=1e-4, atol=1e-5 over two layers (the same sums and
products, taken in another order; as tests/test_infer.py allows against its
float64 oracle).
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from graphsage_tpu import infer as jax_infer
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models.layers import init_classifier as jax_init_clf
from graphsage_torch import infer
from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.models import GraphSageConfig, init_classifier
from graphsage_torch.models import init_graphsage

F32 = dict(rtol=1e-4, atol=1e-5)


def _graph(n=37, extra_edges=90, seed=3):
    """A ring plus random chords, with one explicit self-loop (node 5) to
    check the self-masking rule; as tests/test_infer.py builds it."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([np.arange(n), rng.randint(0, n, extra_edges), [5]])
    dst = np.concatenate([(np.arange(n) + 1) % n,
                          rng.randint(0, n, extra_edges), [5]])
    feats = rng.randn(n, 12).astype(np.float32)
    return CSRGraph.from_edges(n, src, dst, undirected=True), feats


def _jax_model(agg="MEAN", gcn=False, seed=0, n_classes=4):
    cfg = JaxConfig(num_layers=2, input_size=12, out_size=8, agg_func=agg,
                    gcn=gcn)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.device_get({"sage": jax_init_graphsage(k1, cfg),
                             "clf": jax_init_clf(k2, 8, n_classes)})
    return cfg, params


def _port_cfg(jcfg):
    return GraphSageConfig(**{f: getattr(jcfg, f)
                              for f in jcfg.__dataclass_fields__})


@pytest.mark.parametrize("gcn", [False, True])
@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
def test_full_graph_embeddings_matches_jax(agg, gcn):
    g, feats = _graph()
    jcfg, params = _jax_model(agg, gcn)
    want = jax_infer.full_graph_embeddings(params["sage"], jcfg, feats,
                                           g.to_padded())
    got = infer.full_graph_embeddings(params["sage"], _port_cfg(jcfg), feats,
                                      g.to_padded(), device="cpu")
    assert got.dtype == np.float32 and got.shape == (37, 8)
    np.testing.assert_allclose(got, want, **F32)
    assert np.abs(got).sum() > 0


def test_blocking_invariance_and_determinism():
    g, feats = _graph(n=53, extra_edges=140, seed=7)
    cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8)
    params = init_graphsage(torch.Generator().manual_seed(1), cfg)
    pad = g.to_padded()
    a = infer.full_graph_embeddings(params, cfg, feats, pad, block=7,
                                    device="cpu")
    b = infer.full_graph_embeddings(params, cfg, feats, pad, device="cpu")
    c = infer.full_graph_embeddings(params, cfg, feats, pad, device="cpu")
    np.testing.assert_array_equal(b, c)          # bit-identical reruns
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    dev = infer.full_graph_embeddings(params, cfg, feats, pad, fetch=False,
                                      device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), b)


@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
def test_bf16_serving_matches_jax(agg):
    """bf16 tables on both sides: results within 2 bf16 ulps of the row's
    largest magnitude (roundings of different sums can differ by one ulp
    per layer; relu(agg + self) can cancel)."""
    g, feats = _graph(seed=11)
    jcfg, params = _jax_model(agg, seed=5)
    jcfg = JaxConfig(**{**jcfg.__dict__, "compute_dtype": "bfloat16"})
    want = jax_infer.full_graph_embeddings(params["sage"], jcfg, feats,
                                           g.to_padded())
    got = infer.full_graph_embeddings(params["sage"], _port_cfg(jcfg), feats,
                                      g.to_padded(), device="cpu")
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 2 * 2.0**-8 * scale + 1e-30).all()


@pytest.mark.parametrize("agg,gcn", [("MEAN", False), ("MAX", True)])
def test_session_matches_jax_session(agg, gcn):
    g, feats = _graph(seed=13)
    jcfg, params = _jax_model(agg, gcn, seed=2)
    pad = g.to_padded()
    jsess = jax_infer.InferenceSession(params, jcfg, feats, pad)
    sess = infer.InferenceSession(params, _port_cfg(jcfg), feats, pad,
                                  device="cpu")
    nodes = np.array([0, 5, 17, 36])
    np.testing.assert_allclose(sess.embeddings(), jsess.embeddings(), **F32)
    np.testing.assert_allclose(sess.log_probs(nodes), jsess.log_probs(nodes),
                               **F32)
    np.testing.assert_array_equal(sess.predict(nodes), jsess.predict(nodes))
    np.testing.assert_allclose(sess.score_pairs([0, 5, 17], [17, 0, 5]),
                               jsess.score_pairs([0, 5, 17], [17, 0, 5]),
                               **F32)
    assert sess.predict(5).shape == (1,)
    s = sess.score_pairs([3, 4], [3, 9])
    np.testing.assert_allclose(s[0], 1.0, atol=1e-6)


def test_bundle_roundtrip(tmp_path):
    g, feats = _graph()
    cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8,
                          agg_func="MAX")
    gen = torch.Generator().manual_seed(3)
    params = {"sage": init_graphsage(gen, cfg),
              "clf": init_classifier(gen, 8, 4)}
    path = str(tmp_path / "bundle")
    infer.export_bundle(path, params, cfg, 4, meta={"dataset": "toy"})

    restored, rcfg, rncls, meta = infer.load_bundle(path)
    assert rcfg == cfg and rncls == 4 and meta == {"dataset": "toy"}
    np.testing.assert_array_equal(restored["sage"]["layers"][1]["weight"],
                                  params["sage"]["layers"][1]["weight"])
    np.testing.assert_array_equal(restored["clf"]["bias"],
                                  params["clf"]["bias"])

    pad = g.to_padded()
    sess = infer.InferenceSession(params, cfg, feats, pad, device="cpu")
    again = infer.InferenceSession.from_bundle(path, feats, pad,
                                               device="cpu")
    np.testing.assert_array_equal(again.embeddings(), sess.embeddings())
    np.testing.assert_array_equal(again.predict(np.arange(37)),
                                  sess.predict(np.arange(37)))


def test_bundle_json_matches_jax_export(tmp_path):
    """Both packages write the same bundle.json for the same config."""
    import json

    jcfg, params = _jax_model()
    jax_infer.export_bundle(str(tmp_path / "jax"), params, jcfg, 4,
                            meta={"k": 1})
    infer.export_bundle(str(tmp_path / "port"), params, _port_cfg(jcfg), 4,
                        meta={"k": 1})
    read = [json.loads((tmp_path / d / "bundle.json").read_text())
            for d in ("jax", "port")]
    assert read[0] == read[1]


def test_bundle_with_wrong_shapes_is_refused(tmp_path):
    cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8)
    gen = torch.Generator().manual_seed(0)
    params = {"sage": init_graphsage(gen, cfg),
              "clf": init_classifier(gen, 8, 4)}
    path = str(tmp_path / "b")
    infer.export_bundle(path, params, cfg, 5)     # claims 5 classes
    with pytest.raises(ValueError, match="needs"):
        infer.load_bundle(path)


@pytest.mark.parametrize("gcn,lstm_hybrid,block", [
    (False, False, 7), (True, False, 7), (False, True, 7),
    (False, False, None)], ids=["lstm", "lstm_gcn", "hybrid", "one_block"])
def test_lstm_serving_matches_jax(gcn, lstm_hybrid, block):
    """LSTM and cached-LSTM-hybrid full-graph embeddings against JAX's, the
    port in blocks of 7 rows (37 rows: five full blocks and a tail) or
    one."""
    g, feats = _graph(seed=17)
    jcfg, params = _jax_model("LSTM", gcn, seed=6)
    pad = g.to_padded()
    want = jax_infer.full_graph_embeddings(params["sage"], jcfg, feats, pad,
                                           lstm_hybrid=lstm_hybrid)
    got = infer.full_graph_embeddings(params["sage"], _port_cfg(jcfg), feats,
                                      pad, block=block,
                                      lstm_hybrid=lstm_hybrid, device="cpu")
    assert got.shape == (37, 8) and np.abs(got).sum() > 0
    np.testing.assert_allclose(got, want, **F32)
    if lstm_hybrid:
        # the hybrid never reads the layer-0 cell
        sage = dict(params["sage"])
        sage["agg"] = [jax.tree_util.tree_map(np.zeros_like, sage["agg"][0]),
                       sage["agg"][1]]
        np.testing.assert_array_equal(
            infer.full_graph_embeddings(sage, _port_cfg(jcfg), feats, pad,
                                        block=block, lstm_hybrid=True,
                                        device="cpu"), got)


@pytest.mark.parametrize("lstm_hybrid", [False, True])
def test_lstm_sessions_and_bundles_match_jax(lstm_hybrid, tmp_path):
    """An LSTM model (and a hybrid one, meta["lstm_hybrid"]) through a
    bundle round trip and InferenceSession, against the JAX session."""
    g, feats = _graph(seed=19)
    jcfg, params = _jax_model("LSTM", seed=7)
    pad = g.to_padded()
    jsess = jax_infer.InferenceSession(params, jcfg, feats, pad,
                                       lstm_hybrid=lstm_hybrid)
    path = str(tmp_path / "lstm")
    meta = {"lstm_hybrid": True} if lstm_hybrid else None
    infer.export_bundle(path, params, _port_cfg(jcfg), 4, meta=meta)
    restored, cfg, _, _ = infer.load_bundle(path)
    assert [c["w_ih"].shape for c in restored["sage"]["agg"]] == [
        (48, 12), (32, 8)]
    sess = infer.InferenceSession.from_bundle(path, feats, pad, block=5,
                                              device="cpu")
    assert sess.lstm_hybrid == lstm_hybrid
    nodes = np.array([0, 5, 17, 36])
    np.testing.assert_allclose(sess.embeddings(), jsess.embeddings(), **F32)
    np.testing.assert_allclose(sess.log_probs(nodes), jsess.log_probs(nodes),
                               **F32)
    np.testing.assert_array_equal(sess.predict(nodes), jsess.predict(nodes))


def test_card_block_rule():
    """On the card MEAN and MAX layers aggregate all rows in one launch;
    LSTM layers take the byte budget at the layer's input width (3,483
    rows at 32 slots of 602 floats, 16,384 at 128) or the request."""
    assert infer.card_block("MEAN", 100_000, 32, 602, 4) == 100_000
    assert infer.card_block("MAX", 100_000, 32, 602, 2) == 100_000
    assert infer.card_block("LSTM", 100_000, 32, 602, 4) == 3483
    assert infer.card_block("LSTM", 100_000, 32, 128, 4) == 16384
    assert infer.card_block("LSTM", 100_000, 32, 128, 4, 1000) == 1000
    assert infer.card_block("LSTM", 10, 32, 128, 4) == 10


def test_no_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, feats = _graph()
    cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8)
    params = init_graphsage(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.full_graph_embeddings(params, cfg, feats, g.to_padded())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.InferenceSession({"sage": params}, cfg, feats, g.to_padded())


def test_serving_cli(tmp_path, capsys):
    """python -m graphsage_torch.infer on a synthetic power-law graph."""
    from graphsage_torch.data import load_dataset

    ds = load_dataset("powerlaw:300:1200", seed=4)
    cfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                          out_size=8)
    gen = torch.Generator().manual_seed(0)
    path = str(tmp_path / "b")
    infer.export_bundle(path, {"sage": init_graphsage(gen, cfg),
                               "clf": init_classifier(gen, 8,
                                                      ds.num_classes)},
                        cfg, ds.num_classes)
    out_npy = str(tmp_path / "emb.npy")
    assert infer._main(["--bundle", path, "--dataSet", "powerlaw:300:1200",
                        "--seed", "4", "--nodes", "0,7", "--eval",
                        "--save_embeddings", out_npy,
                        "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "node 7: class" in text and "test micro-F1" in text
    assert np.load(out_npy).shape == (300, 8)


def test_port_imports_neither_jax_nor_the_jax_package():
    """With jax and graphsage_tpu made unimportable, every module of the
    port and chip_smoke.py still import."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'graphsage_tpu', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "import graphsage_torch, graphsage_torch.infer, "
        "graphsage_torch.convert, graphsage_torch.ops.build, "
        "graphsage_torch.train.metrics, graphsage_torch.data\n"
        "import graphsage_torch.cli, graphsage_torch.train.trainer, "
        "graphsage_torch.train.optim, graphsage_torch.sampler, "
        "graphsage_torch.sampler.compact, graphsage_torch.sampler.pairs, "
        "graphsage_torch.native, graphsage_torch.native.build, "
        "graphsage_torch.ops.sddmm, graphsage_torch.losses, "
        "graphsage_torch.utils, graphsage_torch.utils.obs, "
        "graphsage_torch.utils.prefetch, graphsage_torch.models.graphsage, "
        "graphsage_torch.ops.gather, graphsage_torch.sampler.device, "
        "graphsage_torch.train.cached, graphsage_torch.train.cached_trainer, "
        "graphsage_torch.microbench, graphsage_torch.kernel_ab, "
        "graphsage_torch.models.lstm_agg, graphsage_torch.train.dense, "
        "graphsage_torch.entry, graphsage_torch.ops.scatter, "
        "graphsage_torch.utils.config, graphsage_torch.utils.checkpoint, "
        "graphsage_torch.supervise\n"
        "import chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'graphsage_tpu') "
        "for m, v in sys.modules.items() if v is not None)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result with no card, and
    when it stands alone in a directory without the repository."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(root, "chip_smoke.py"), alone)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd in (root, str(alone)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=env)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
