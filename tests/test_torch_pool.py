"""GraphSAGE-pool (``agg_func="POOL"``) in graphsage_torch against the plain
reference ``benchmark/reference/sage_pool.py``, on the CPU.

The reference applies the pool MLP to every row, gathers all S slots of the
pooled rows and takes ``torch.amax``, in float32; the port transforms each
source row once (``models.layers.pool_transform``), then takes
``ops.aggregate.max_aggregate`` with its tie-splitting backward.

Tolerances, and why:
- float32 forward (the compact encoder, full-graph serving): rtol = atol =
  1e-5.  The same float32 products summed in another order (the port's
  float32 ``torch.matmul`` over the concatenation, the reference's per
  block); a max is exact.
- float32 gradients after one step (sup, plus_unsup): every leaf within
  1e-5 of its largest element, the clipped gradient (p0 - p1) / lr against
  the reference's.  The backward sums the same products in another order,
  and the two divide by lr a difference of two floats near 1.
- bfloat16 serving: within 2 bfloat16 ulps plus 4e-3, the bar of
  ``tests/test_torch_bf16.py``, of the float32 reference that rounds its
  stored tables to bfloat16 where the port does (the pooled table, each
  layer's output): the same roundings of sums taken in another order.
  Against the all-float32 reference those roundings, half an ulp each,
  add up over two layers (1.2 ulps of a 2.4 entry here), so that
  comparison is by the worst row's relative gap, under 0.02.
- the pool transform of a bfloat16 table outside autograd: the three-piece
  bar of ``tests/test_torch_pretransform.py`` against relu(h @ W^T + b)
  summed in float32 and rounded once (identical on 99.9% of elements): a
  dropped bias or relu, or a weight taken as one bfloat16 piece, breaks it.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import sage_pool
from benchmark.reference.precision import EXACT, Precision
from graphsage_torch import cli, infer
from graphsage_torch.convert import params_to_numpy
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig, init_classifier
from graphsage_torch.models.graphsage import (Frontier,
                                              graphsage_apply_gathered,
                                              init_graphsage)
from graphsage_torch.models.layers import pool_transform
from graphsage_torch.ops import pretransform as pt
from graphsage_torch.train import (CachedTrainer, DistTrainConfig,
                                   DistTrainer, Trainer, TrainConfig)
from graphsage_torch.train.dense import (make_dense_sup_step,
                                         make_dense_unsup_step)
from graphsage_torch.utils import obs
from test_torch_pretransform import assert_three_piece_bar

D, H, P = 24, 16, 20
F32 = dict(rtol=1e-5, atol=1e-5)
# float32 arithmetic whose stored tables are rounded to bfloat16, as the
# port's bfloat16 serving stores them
BF16_TABLES = Precision("bfloat16 tables",
                        lambda x: x.float().bfloat16().float(),
                        lambda x: x.float())


def _cfg(**kw):
    return GraphSageConfig(num_layers=2, input_size=D, out_size=H,
                           agg_func="POOL", pool_size=P, **kw)


def _params(cfg, seed=0):
    """Initial params with a nonzero pool bias (init_pool's is zero)."""
    gen = torch.Generator().manual_seed(seed)
    sage_p = init_graphsage(gen, cfg)
    for q in sage_p["pool"]:
        q["bias"] = torch.rand(P, generator=gen) * 0.4 - 0.2
    return sage_p


def _frontiers(gen, rows, slots=5):
    """Bottom-up frontiers over ``rows`` = [U0, U1, U2]: random slots,
    masks with empty rows and a padded last row."""
    out = []
    for below, above in zip(rows[:-1], rows[1:]):
        idx = torch.randint(0, below, (above, slots), generator=gen,
                            dtype=torch.int32)
        mask = (torch.rand(above, slots, generator=gen) < 0.7).float()
        mask[0] = 0                                  # no valid slot
        mask[-1] = 0
        idx[-1] = 0
        self_idx = torch.randint(0, below, (above,), generator=gen,
                                 dtype=torch.int32)
        out.append(Frontier(idx, mask, self_idx))
    return out


def _as_ref(frontiers):
    return [(f.idx, f.mask, f.self_idx) for f in frontiers]


def test_init_lays_out_the_pool_layers():
    cfg = _cfg()
    p = init_graphsage(torch.Generator().manual_seed(0), cfg)
    assert [tuple(l["weight"].shape) for l in p["layers"]] == [
        (H, D + P), (H, H + P)]
    assert [tuple(q["weight"].shape) for q in p["pool"]] == [(P, D), (P, H)]
    assert all(torch.equal(q["bias"], torch.zeros(P)) for q in p["pool"])
    gcn = init_graphsage(torch.Generator().manual_seed(0), _cfg(gcn=True))
    assert [tuple(l["weight"].shape) for l in gcn["layers"]] == [(H, P)] * 2


def test_compact_forward_matches_reference_f32():
    cfg = _cfg()
    params = _params(cfg)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(90, D, generator=gen)
    x0_ids = torch.randint(0, 90, (60,), generator=gen, dtype=torch.int32)
    fr = _frontiers(gen, [60, 25, 7])
    got = graphsage_apply_gathered(params, cfg, feats, x0_ids, fr)
    want = sage_pool.encode(params, feats[x0_ids.long()], _as_ref(fr))
    torch.testing.assert_close(got, want, **F32)
    assert (got[0] != 0).any() and (want.abs().sum() > 0)


def _graph(n=120, e=500, seed=3):
    ds = synthetic_power_law(n, e, num_feats=D, num_classes=4, seed=seed)
    pad = ds.graph.to_padded_sampled(6, np.random.RandomState(seed))
    return ds, pad


def _ref_full(params, feats, pad, p=EXACT):
    return sage_pool.full_graph({"sage": params}, torch.as_tensor(feats),
                                torch.as_tensor(pad.neighbors),
                                torch.as_tensor(pad.degrees), p, block=37)


def test_full_graph_serving_matches_reference_f32():
    ds, pad = _graph()
    cfg = _cfg()
    params = _params(cfg)
    got = infer.full_graph_embeddings(params, cfg, ds.features, pad,
                                      device="cpu", block=29)
    want = _ref_full(params, ds.features, pad)
    np.testing.assert_allclose(got, want.numpy(), **F32)
    assert np.abs(got).sum() > 0


def test_bf16_serving_within_two_ulps_of_the_f32_reference():
    """Held to the float32 reference that stores its tables (the pooled
    rows, each layer's output) in bfloat16 where the port does, by the bar
    of ``tests/test_torch_bf16.py``; and to the all-float32 reference by
    the worst row's relative gap, the benchmark's ``emb_gap`` (the roundings
    carried through two layers: 0.006 here)."""
    ds, pad = _graph()
    cfg = _cfg(compute_dtype="bfloat16")
    params = _params(cfg)
    feats = torch.from_numpy(ds.features).bfloat16().float()
    got = infer.full_graph_embeddings(params, cfg, feats, pad, device="cpu")
    want = _ref_full(params, feats, pad, BF16_TABLES).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    err = np.abs(got - want)
    assert (err <= 2 * ulp + 4e-3).all(), float(err.max())
    exact = _ref_full(params, feats, pad)
    assert compare.row_gap(torch.from_numpy(got), exact) < 0.02


def test_pool_transform_of_a_bf16_table_rounds_the_float32_sums_once():
    """Outside autograd a bfloat16 table takes the three-piece pretransform
    with its epilogue: relu(h @ W^T + b) in float32, rounded once."""
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(700, 602, generator=gen).bfloat16()
    a = (6.0 / (602 + 512)) ** 0.5
    params = {"weight": (torch.rand(512, 602, generator=gen) * 2 - 1) * a,
              "bias": torch.rand(512, generator=gen) * 0.2 - 0.1}
    with torch.no_grad():
        got = pool_transform(params, h)
    want = torch.relu(torch.matmul(h.float(), params["weight"].T)
                      + params["bias"]).bfloat16()
    assert_three_piece_bar(got, want, h, params["weight"])
    assert 0.3 < float((got == 0).float().mean()) < 0.7
    assert torch.equal(got, pt.pretransform_plain(
        h, pt.split_weight(params["weight"]), params["bias"]))


def _ties():
    """Three slots of row 0 hold one feature row each, alike (a three-way
    positive tie), and the pool bias makes columns 0-4 zero for every row:
    max over slots that are all 0."""
    gen = torch.Generator().manual_seed(7)
    cfg = GraphSageConfig(num_layers=1, input_size=D, out_size=H,
                          agg_func="POOL", pool_size=P)
    params = _params(cfg)
    params["pool"][0]["bias"][:5] = -100.0
    h = torch.randn(9, D, generator=gen)
    h[4] = h[2]
    h[6] = h[2]
    idx = torch.tensor([[2, 4, 6, 1], [3, 5, 7, 8], [0, 2, 4, 8]],
                       dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
                        dtype=torch.float32)
    fr = [Frontier(idx, mask, torch.tensor([0, 3, 8], dtype=torch.int32))]
    return cfg, params, h, fr


def test_ties_split_the_gradient_as_amax_does():
    cfg, params, h, fr = _ties()
    g = torch.randn(3, H, generator=torch.Generator().manual_seed(8))
    grads = []
    for encode in ("port", "reference"):
        p = {k: [{n: t.clone().requires_grad_(True) for n, t in d.items()}
                 for d in v] for k, v in params.items()}
        x = h.clone().requires_grad_(True)
        if encode == "port":
            out = graphsage_apply_gathered(
                p, cfg, x, torch.arange(9, dtype=torch.int32), fr)
        else:
            out = sage_pool.encode(p, x, _as_ref(fr))
        (out * g).sum().backward()
        grads.append([x.grad] + [t.grad for d in p["layers"] + p["pool"]
                                 for t in d.values()])
        z = pool_transform(params["pool"][0], h)
        assert (z[:, :5] == 0).all()
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **F32)
    # the tie: the three alike rows share row 0's gradient equally
    assert torch.equal(grads[0][0][2], grads[0][0][4])


def _step_inputs(pb, cb, labels_all):
    nu = int(pb.num_unique)
    rows = cb.frontiers[-1].idx.shape[0]
    labels = torch.zeros(rows, dtype=torch.long)
    labels[:nu] = torch.as_tensor(labels_all[pb.unique_nodes[:nu]]).long()

    def t(a):
        return torch.as_tensor(np.asarray(a))

    return {"x0_ids": t(cb.x0_ids),
            "frontiers": [(t(f.idx), t(f.mask), t(f.self_idx))
                          for f in cb.frontiers],
            "labels": labels,
            "row_mask": (torch.arange(rows) < nu).float(),
            "pairs": {f: t(getattr(pb, f)) for f in (
                "target_rows", "pos_q", "pos_mask", "neg_q", "neg_mask",
                "node_valid")}}


def _flat(params):
    s = params["sage"]
    return ([l["weight"] for l in s["layers"]]
            + [t for q in s["pool"] for t in (q["weight"], q["bias"])]
            + [params["clf"]["weight"], params["clf"]["bias"]])


@pytest.mark.parametrize("learn_method", ["sup", "plus_unsup"])
def test_one_step_gradients_match_reference(learn_method, monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, _ = _graph(200, 900)
    cfg = _cfg()
    params = {"sage": _params(cfg),
              "clf": init_classifier(torch.Generator().manual_seed(2), H,
                                     ds.num_classes)}
    tcfg = TrainConfig(learn_method=learn_method, unsup_loss="margin",
                       b_sz=16, lr=0.7, seed=5, prefetch_depth=0,
                       verbose=False, fanout=4)
    tr = Trainer(ds, cfg, tcfg, params=params, device="cpu")
    pb, cb, labels, row_mask = tr._build_train_batch(ds.train_nodes[:16])
    p0 = [t.detach().clone() for t in _flat(tr.params)]
    tr._step(pb, cb, labels, row_mask)
    got = [(a - b.detach()) / tcfg.lr for a, b in zip(p0, _flat(tr.params))]
    step = _step_inputs(pb, cb, ds.labels)
    x = torch.from_numpy(ds.features)
    ref = sage_pool.sgd(params, [lambda q: sage_pool.compact_loss(
        q, x, step, learn_method, tr.pair_sampler.margin, EXACT)],
        tcfg.lr, tcfg.clip_norm)["grad1"]
    tr.pair_sampler.close()
    assert len(got) == len(ref) == 2 + 4 + 2
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
        assert float(r.abs().max()) > 0


def test_bf16_step_runs_with_float32_masters(monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, _ = _graph(200, 900)
    cfg = _cfg(compute_dtype="bfloat16")
    tcfg = TrainConfig(learn_method="plus_unsup", unsup_loss="margin",
                       b_sz=32, epochs=1, seed=5, prefetch_depth=0,
                       verbose=False, fanout=4)
    tr = Trainer(ds, cfg, tcfg, device="cpu")
    before = [t.detach().clone() for t in _flat(tr.params)]
    tr.train_epoch()
    tr.pair_sampler.close()
    assert np.isfinite(tr.step_losses).all()
    after = _flat(tr.params)
    assert all(t.dtype == torch.float32 for t in after)
    assert all(not torch.equal(a, b) for a, b in zip(before, after))


def test_the_other_pipelines_refuse_pool(monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, pad = _graph()
    cfg = _cfg()
    with pytest.raises(ValueError, match="POOL is not supported by the "
                                         "cached pipelines"):
        CachedTrainer(ds, cfg, TrainConfig(verbose=False), device="cpu")
    for make in (make_dense_sup_step, make_dense_unsup_step):
        with pytest.raises(ValueError, match="the dense pipeline"):
            make(cfg)
    with pytest.raises(ValueError, match="the dist pipeline"):
        DistTrainer(ds, cfg, DistTrainConfig(verbose=False), device="cpu")
    with pytest.raises(ValueError, match="full_graph_embeddings_sharded"):
        infer.full_graph_embeddings_sharded(_params(cfg), cfg, ds.features,
                                            pad, device="cpu")
    with pytest.raises(ValueError, match="POOL"):
        cli.main(["--dataSet", "powerlaw:100:400", "--device", "cpu",
                  "--epochs", "1", "--quiet", "--pipeline", "cached",
                  "--agg_func", "POOL"])


def test_bundle_round_trip_records_pool_size(tmp_path):
    ds, pad = _graph()
    cfg = _cfg()
    params = {"sage": _params(cfg),
              "clf": init_classifier(torch.Generator().manual_seed(2), H, 4)}
    infer.export_bundle(str(tmp_path / "pool"), params, cfg, 4)
    record = json.loads((tmp_path / "pool" / "bundle.json").read_text())
    assert record["model"]["pool_size"] == P
    back, mcfg, ncls, _ = infer.load_bundle(str(tmp_path / "pool"))
    assert mcfg == cfg and ncls == 4
    for a, b in zip(_flat(params_to_numpy(params)), _flat(back)):
        np.testing.assert_array_equal(a, b)
    sess = infer.InferenceSession.from_bundle(str(tmp_path / "pool"),
                                              ds.features, pad, device="cpu")
    np.testing.assert_array_equal(sess.embeddings(), infer.full_graph_embeddings(
        params["sage"], cfg, ds.features, pad, device="cpu"))
    # every other aggregator's record stays the JAX package's
    mean = GraphSageConfig(num_layers=2, input_size=D, out_size=H)
    infer.export_bundle(str(tmp_path / "mean"),
                        {"sage": init_graphsage(torch.Generator(), mean),
                         "clf": params["clf"]}, mean, 4)
    record = json.loads((tmp_path / "mean" / "bundle.json").read_text())
    assert "pool_size" not in record["model"]


def test_cli_trains_pool_exports_and_serves(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    out = str(tmp_path / "pool")
    trainer, best = cli.run([
        "--dataSet", "powerlaw:300:1200", "--agg_func", "POOL",
        "--pool_size", "12", "--learn_method", "plus_unsup", "--epochs", "1",
        "--b_sz", "100", "--hidden", "8", "--device", "cpu", "--export", out,
        "--seed", "3", "--quiet", "--checkpoint_dir", str(tmp_path / "ck")])
    assert type(trainer).__name__ == "Trainer"
    assert np.isfinite(trainer.step_losses).all()
    params, mcfg, _, _ = infer.load_bundle(out)
    assert mcfg.agg_func == "POOL" and mcfg.pool_size == 12
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features, pad,
                                       device="cpu")
    np.testing.assert_array_equal(sess.embeddings(), want)
    assert np.isfinite(want).all() and np.abs(want).sum() > 0


def _profiled(fn):
    """The span store's records of ``fn()`` run under a CPU profile."""
    from torch.profiler import ProfilerActivity, profile
    obs.records(clear=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return obs.records(clear=True)
    finally:
        obs.records(clear=True)


def test_serving_and_training_mark_the_pool_transforms(monkeypatch):
    """``serve.pool`` a layer (its rows), ``step.pool`` a layer of the
    compact step's forward, and the rows of every transform in
    ``pool.transform_rows``."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, pad = _graph()
    cfg = _cfg()
    rec = _profiled(lambda: infer.full_graph_embeddings(
        _params(cfg), cfg, ds.features, pad, device="cpu"))
    spans = [s for s in rec["spans"] if s["name"] == "serve.pool"]
    assert sorted(s["counts"]["layer"] for s in spans) == [0, 1]
    assert {s["counts"]["rows"] for s in spans} == {ds.num_nodes}
    assert {s["parent"] for s in spans} == {None}
    assert rec["counts"]["pool.transform_rows"] == 2 * ds.num_nodes

    tr = Trainer(ds, cfg, TrainConfig(b_sz=16, seed=5, prefetch_depth=0,
                                      verbose=False, fanout=4), device="cpu")
    batch = tr._build_train_batch(ds.train_nodes[:16])
    rec = _profiled(lambda: tr._step(*batch))
    tr.pair_sampler.close()
    spans = [s for s in rec["spans"] if s["name"] == "step.pool"]
    assert sorted(s["counts"]["layer"] for s in spans) == [0, 1]
    assert {s["parent"] for s in spans} == {"step.forward"}
    cb = batch[1]
    assert [s["counts"]["rows"] for s in sorted(
        spans, key=lambda s: s["counts"]["layer"])] == [
        len(cb.x0_ids), cb.frontiers[0].idx.shape[0]]
    assert rec["counts"]["pool.transform_rows"] == sum(
        s["counts"]["rows"] for s in spans)


def test_pool_train_check_runs_on_the_cpu(capsys):
    """``benchmark/pool_train_check.py``, the card's training check, run at
    a small size on the CPU: three sup steps of the compact ``Trainer`` in
    bfloat16 against the float32 reference on the recorded draws.  Each of
    its readings of the program lies below the same reading of the control
    (the reference in float8 arithmetic), as on the card."""
    from benchmark import pool_train_check
    small = {"graph": {"num_nodes": 3000, "num_edges": 15000,
                       "num_feats": 64},
             "model": {"hidden": 32, "pool_size": 48}}
    assert pool_train_check.main(
        ["--seed", str(2**31 + 5), "--steps", "3", "--b_sz", "32"],
        device="cpu", overrides=small) == 0
    found = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert found["kind"] == "cpu" and len(found["losses"]) == 3
    assert all(np.isfinite(found["losses"]))
    for key in ("loss_gap", "grad1_gap", "grad1_diff", "update_gap"):
        assert found["program"][key] < found["control"][key], key
