"""The port's halo-exchange pipeline (graphsage_torch.train.distributed)
against the JAX package's (graphsage_tpu.train.distributed), on the CPU.

The JAX side is ``shard_map`` on the first P virtual CPU devices
(tests/conftest.py forces 8); the port side is P gloo ranks, one process
each (tests/torch_dist_worker.py), for P in {1, 2, 4}.  Every check of one
world size shares one launch of the ranks.

- Host batches (``build_dist_batch``, ``build_dist_unsup_batch``, the
  native sampler's frontiers, the halo plan, the pair tensors):
  bit-identical.
- One step from the same params (copied from the JAX init) and the same
  batch: sup MEAN with the pretransform (the [·, 2H] payload), sup MAX
  (raw features over the exchange), unsup normal and margin, plus_unsup;
  float32 losses within rtol 1e-5 and updated params within atol 1e-6
  (the same sums in other orders).  sup MEAN in bfloat16 under
  tests/test_torch_bf16.py's bars (loss rtol 1e-2, each leaf's update
  within 2e-2 of JAX's largest).
- Every rank ends the step with the same params, bit for bit.
- The pmean trap (``distributed.py:222-228``): the step's update equals
  the port's own single-device step on the concatenated batch (the mean
  NLL over all P·b_loc rows, equal shards), loss rtol 1e-5, params atol
  1e-6; gradients summed over ranks instead of averaged would be P times
  too large.
- The padded tail: rows with row_mask 0 do not reach the loss or the
  update (corrupting their labels changes nothing, bit for bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.models.layers import init_classifier as jax_init_clf
from graphsage_tpu.parallel.halo import shard_features as jax_shard
from graphsage_tpu.sampler import PairSampler as JaxPairSampler
from graphsage_tpu.train import distributed as jd
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models import Frontier, GraphSageConfig
from graphsage_torch.models.graphsage import graphsage_apply
from graphsage_torch.models.layers import classifier_apply
from graphsage_torch.parallel.halo import shard_features
from graphsage_torch.sampler import PairSampler
from graphsage_torch.train import distributed
from graphsage_torch.train.optim import apply_gradients
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_bf16 import assert_step_close
from tests.torch_dist_worker import run_ranks

N, E, D, H, C, FANOUT, B_LOC = 600, 3000, 24, 16, 4, 4, 6
LR, CLIP = 0.4, 5.0
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")

# name: (learn_method, unsup_loss, agg_func, compute_dtype)
STEPS = {"sup": ("sup", "normal", "MEAN", "float32"),
         "sup_max": ("sup", "normal", "MAX", "float32"),
         "sup_bf16": ("sup", "normal", "MEAN", "bfloat16"),
         "unsup": ("unsup", "normal", "MEAN", "float32"),
         "unsup_margin": ("unsup", "margin", "MEAN", "float32"),
         "plus_unsup": ("plus_unsup", "normal", "MEAN", "float32")}


# the evaluation forward of a bfloat16 model
FORWARD_AGGS = ("MEAN", "MAX")
FWD_TOL = 1e-5


def _jcfg(agg="MEAN", dtype="float32"):
    return JaxConfig(num_layers=2, input_size=D, out_size=H, agg_func=agg,
                     compute_dtype=dtype)


def _params(jcfg):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return jax.device_get({"sage": jax_init_graphsage(k1, jcfg),
                           "clf": jax_init_clf(k2, H, C)})


def _batch_payload(db) -> dict:
    return {**{f.name: getattr(db, f.name)
               for f in dataclasses.fields(db) if f.name != "frontiers"},
            "frontiers": [{"idx": f.idx, "mask": f.mask,
                           "self_idx": f.self_idx} for f in db.frontiers]}


def _assert_batches_equal(db, jdb):
    for f in dataclasses.fields(db):
        if f.name == "frontiers":
            for a, b in zip(db.frontiers, jdb.frontiers):
                for k in ("idx", "mask", "self_idx"):
                    np.testing.assert_array_equal(getattr(a, k),
                                                  getattr(b, k))
            continue
        a, b = getattr(db, f.name), getattr(jdb, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.fixture(scope="module")
def data():
    return (synthetic_power_law(N, E, num_feats=D, num_classes=C, seed=2),
            jax_power_law(N, E, num_feats=D, num_classes=C, seed=2))


def _jax_step(name, world, jds, params, jdb, jpairs):
    method, loss_kind, agg, dtype = STEPS[name]
    jcfg = _jcfg(agg, dtype)
    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data",))
    feats = jax.device_put(jnp.asarray(jax_shard(jds.features, world)),
                           NamedSharding(mesh, P("data", None)))
    p = jax.device_put(params, NamedSharding(mesh, P()))
    args = jd.dist_batch_to_device(jdb, mesh)
    if method == "sup":
        step = jd.make_dist_sup_step(jcfg, mesh, lr=LR, clip=CLIP)
        new, loss = step(p, feats, *args)
    else:
        step = jd.make_dist_unsup_step(jcfg, mesh, unsup_loss=loss_kind,
                                       learn_method=method, lr=LR,
                                       clip=CLIP)
        new, loss = step(p, feats, *args,
                         *jd.pairs_to_device(jpairs, mesh))
    return float(loss), jax.device_get(new)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def stepped(request, data):
    """Every step of STEPS, and the tail-mask pair, on P ranks."""
    world = request.param
    ds, jds = data
    rng = np.random.RandomState(7 + world)
    batch = ds.train_nodes[rng.choice(len(ds.train_nodes), (world, B_LOC))]
    db = distributed.build_dist_batch(ds.graph, ds.labels, batch, 2, FANOUT,
                                      seed=5)
    jdb = jd.build_dist_batch(jds.graph, jds.labels, batch, 2, FANOUT,
                              seed=5)
    ps = PairSampler(ds.graph, ds.train_nodes, negative_mode="exact")
    jps = JaxPairSampler(jds.graph, jds.train_nodes, negative_mode="exact")
    unsup = {}
    for kind in ("normal", "margin"):
        num_neg = 6 if kind == "margin" else 100
        unsup[kind] = (
            distributed.build_dist_unsup_batch(
                ds.graph, ds.labels, ps, batch, 2, FANOUT, num_neg, seed=9),
            jd.build_dist_unsup_batch(
                jds.graph, jds.labels, jps, batch, 2, FANOUT, num_neg,
                seed=9))
    valid = np.ones((world, B_LOC), bool)
    valid[-1, 3:] = False      # a short tail on the last rank
    tail = distributed.build_dist_batch(ds.graph, ds.labels, batch, 2,
                                        FANOUT, seed=5, valid=valid)
    junk = tail.labels.copy()
    junk[-1, 3:] = (junk[-1, 3:] + 1) % C
    tail_junk = dataclasses.replace(tail, labels=junk)

    feats = shard_features(ds.features, world)
    jobs, jax_inputs = [], {}
    for name, (method, loss_kind, agg, dtype) in STEPS.items():
        params = _params(_jcfg(agg, dtype))
        if method == "sup":
            b, jb, pairs, jpairs = db, jdb, None, None
        else:
            (b, pairs), (jb, jpairs) = unsup[loss_kind]
        jax_inputs[name] = (params, jb, jpairs)
        jobs.append((name, "dist_step", dict(
            cfg=dataclasses.asdict(_jcfg(agg, dtype)), params=params,
            feats=feats, batch=_batch_payload(b), pairs=pairs,
            learn_method=method, unsup_loss=loss_kind, lr=LR, clip=CLIP,
            q=10.0, margin=3.0)))
    for name, b in (("tail", tail), ("tail_junk", tail_junk)):
        jobs.append((name, "dist_step", {**jobs[0][2],
                                         "batch": _batch_payload(b)}))
    for agg in FORWARD_AGGS:
        jcfg = _jcfg(agg, "bfloat16")
        jobs.append((f"forward_{agg}", "dist_forward", dict(
            cfg=dataclasses.asdict(jcfg), params=_params(jcfg), feats=feats,
            batch=_batch_payload(db))))
    out = run_ranks(jobs, world)
    return dict(world=world, db=db, jdb=jdb, unsup=unsup, out=out,
                jax_inputs=jax_inputs)


def test_build_dist_batch_equals_jax(stepped):
    _assert_batches_equal(stepped["db"], stepped["jdb"])
    for (db, pairs), (jdb, jpairs) in stepped["unsup"].values():
        _assert_batches_equal(db, jdb)
        for k in distributed.PAIR_FIELDS:
            np.testing.assert_array_equal(pairs[k], jpairs[k], err_msg=k)


def test_sample_dense_host_equals_jax(data):
    ds, jds = data
    for gcn in (False, True):
        x0, fr = distributed.sample_dense_host(ds.graph, ds.train_nodes[:9],
                                               2, FANOUT, 17, gcn)
        jx0, jfr = jd.sample_dense_host(jds.graph, jds.train_nodes[:9], 2,
                                        FANOUT, 17, gcn)
        np.testing.assert_array_equal(x0, jx0)
        for a, b in zip(fr, jfr):
            for k in ("idx", "mask", "self_idx"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("name", list(STEPS))
def test_dist_step_matches_jax(stepped, data, name):
    ds, jds = data
    params, jb, jpairs = stepped["jax_inputs"][name]
    want_loss, want = _jax_step(name, stepped["world"], jds, params, jb,
                                jpairs)
    got = stepped["out"][0][name]
    leaves = zip(jax.tree_util.tree_leaves(got["params"]),
                 jax.tree_util.tree_leaves(want))
    if STEPS[name][3] == "bfloat16":
        assert_step_close(name, got["loss"], want_loss, params,
                          got["params"], want)
        return
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
    for a, b in leaves:
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("agg", FORWARD_AGGS)
def test_dist_forward_of_a_bf16_model_matches_jax(stepped, data, agg):
    """make_dist_forward as the trainers call it (float32 master params,
    the float32 feature shard) against the JAX package's, on every rank's
    rows: float32 out, within rtol = atol = 1e-5.  Rounding the params or
    the table to bfloat16 first lands about 1e-3 away."""
    from graphsage_tpu.train.dist_trainer import make_dist_forward

    _, jds = data
    world = stepped["world"]
    jcfg = _jcfg(agg, "bfloat16")
    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data",))
    feats = jax.device_put(jnp.asarray(jax_shard(jds.features, world)),
                           NamedSharding(mesh, P("data", None)))
    sage = jax.device_put(_params(jcfg)["sage"], NamedSharding(mesh, P()))
    args = jd.dist_batch_to_device(stepped["jdb"], mesh)
    want = np.asarray(make_dist_forward(jcfg, mesh)(sage, feats,
                                                    *args[:-2]))
    assert want.dtype == np.float32
    outs = [stepped["out"][r][f"forward_{agg}"] for r in range(world)]
    assert all(o["dtype"] == "torch.float32" for o in outs)
    np.testing.assert_allclose(np.concatenate([o["embs"] for o in outs]),
                               want, rtol=FWD_TOL, atol=FWD_TOL)


def test_ranks_hold_identical_params(stepped):
    out = stepped["out"]
    for name in STEPS:
        for r in range(1, stepped["world"]):
            assert out[r][name]["loss"] == out[0][name]["loss"]
            for a, b in zip(jax.tree_util.tree_leaves(out[r][name]["params"]),
                            jax.tree_util.tree_leaves(out[0][name]["params"])):
                np.testing.assert_array_equal(a, b)


def _concatenated(db):
    """The P shards' x0 ids, frontiers, labels and masks as one batch (the
    frontier indices shifted by each shard's offset at their level)."""
    world = db.x0_ids.shape[0]
    x0 = db.x0_ids.reshape(-1)
    frontiers, below = [], db.x0_ids.shape[1]
    for f in db.frontiers:
        off = (np.arange(world) * below).astype(np.int32)
        frontiers.append(Frontier(
            idx=torch.from_numpy((f.idx + off[:, None, None]).reshape(
                -1, f.idx.shape[2])),
            mask=torch.from_numpy(f.mask.reshape(-1, f.mask.shape[2])),
            self_idx=torch.from_numpy((f.self_idx + off[:, None]).reshape(
                -1))))
        below = f.idx.shape[1]
    return (x0, frontiers, torch.from_numpy(db.labels.reshape(-1)),
            torch.from_numpy(db.row_mask.reshape(-1)))


def test_update_equals_single_device_step_on_concatenated_batch(stepped,
                                                                data):
    """The pmean trap: P ranks' step == one process's step on all rows."""
    ds, _ = data
    params, _, _ = stepped["jax_inputs"]["sup"]
    x0, frontiers, labels, mask = _concatenated(stepped["db"])
    p = _leaf_params(params, CPU)
    cfg = GraphSageConfig(num_layers=2, input_size=D, out_size=H)
    embs = graphsage_apply(p["sage"], cfg,
                           torch.from_numpy(ds.features[x0]), frontiers)
    loss = supervised_nll(classifier_apply(p["clf"], embs), labels, mask)
    apply_gradients(p, loss, ("sage", "clf"), LR, CLIP)
    got = stepped["out"][0]["sup"]
    np.testing.assert_allclose(got["loss"], float(loss.detach()),
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL)


def test_tail_row_mask_zeroes_padded_rows(stepped):
    out = stepped["out"]
    for r in range(stepped["world"]):
        a, b = out[r]["tail"], out[r]["tail_junk"]
        assert a["loss"] == b["loss"]
        for x, y in zip(jax.tree_util.tree_leaves(a["params"]),
                        jax.tree_util.tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    # and the masked rows are really out: the full-mask step differs
    assert out[0]["tail"]["loss"] != out[0]["sup"]["loss"]


def check_cli_resume(pipeline: str, extra: list, tmp_path) -> None:
    """``torchrun --nproc_per_node 2 -m graphsage_torch.cli --device cpu
    --pipeline PIPELINE``: 3 epochs with checkpoints, metrics and
    ``--export``; rank 0 alone prints, and the bundle serves.  Then the
    run resumed from its epoch-0 checkpoint: epochs 1-2's mean losses equal
    the unbroken run's bit for bit (supervised resume is exact: params,
    RandomState and, for cached_dist, the replicated key generator)."""
    import glob
    import json

    from graphsage_torch.data import load_dataset
    from graphsage_torch.infer import InferenceSession
    from tests.torch_dist_worker import run_cli_ranks

    base = ["--dataSet", "powerlaw:600:3000", "--device", "cpu",
            "--pipeline", pipeline, "--epochs", "3", "--b_sz", "64",
            "--seed", "5", "--name", "run", *extra]

    def run(tag, *more):
        proc = run_cli_ranks(base + ["--checkpoint_dir", str(tmp_path / tag),
                                     "--metrics",
                                     str(tmp_path / f"{tag}.jsonl"), *more],
                             2, tmp_path)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        with open(tmp_path / f"{tag}.jsonl") as f:
            recs = [json.loads(line) for line in f]
        return proc, {r["epoch"]: r["mean_loss"] for r in recs
                      if r["event"] == "epoch"}

    bundle = str(tmp_path / "bundle")
    full, losses = run("full", "--export", bundle)
    assert full.stdout.count("Best validation F1") == 1, full.stdout
    assert sorted(losses) == [0, 1, 2]
    ds = load_dataset("powerlaw:600:3000", seed=5)
    sess = InferenceSession.from_bundle(bundle, ds.features,
                                        ds.graph.to_padded(), device="cpu")
    assert np.isfinite(sess.embeddings()).all()
    ckpt = glob.glob(str(tmp_path / "full" / "model_best_run_ep0_*"))
    assert len(ckpt) == 1, ckpt
    resumed, resumed_losses = run("resumed", "--resume", ckpt[0])
    assert "resumed from" in resumed.stdout
    assert resumed_losses == {e: losses[e] for e in (1, 2)}, (
        resumed_losses, losses)


def test_cli_dist_two_ranks_export_and_resume(tmp_path):
    check_cli_resume("dist", [], tmp_path)


def check_cli_unsup(pipeline: str, extra: list, tmp_path) -> None:
    """The CLI on 2 gloo ranks under torchrun with an unsupervised learn
    method: it runs to its end, rank 0 alone prints, and every epoch's
    mean loss is finite."""
    import json

    from tests.torch_dist_worker import run_cli_ranks

    metrics = tmp_path / "m.jsonl"
    proc = run_cli_ranks(["--dataSet", "powerlaw:600:3000", "--device",
                          "cpu", "--pipeline", pipeline, "--epochs", "2",
                          "--b_sz", "64", "--clf_epochs", "2",
                          "--checkpoint_dir", str(tmp_path / "ck"),
                          "--metrics", str(metrics), *extra], 2, tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Best validation F1") == 1, proc.stdout
    with open(metrics) as f:
        losses = [json.loads(line)["mean_loss"] for line in f
                  if json.loads(line)["event"] == "epoch"]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses


@pytest.mark.parametrize("method", ["unsup", "plus_unsup"])
def test_cli_dist_two_ranks_unsupervised(method, tmp_path):
    check_cli_unsup("dist", ["--learn_method", method], tmp_path)


@pytest.fixture
def world1():
    """A world-1 gloo group in this process (an in-memory store), torn
    down after the test."""
    import torch.distributed as dist

    from graphsage_torch.parallel import multihost

    assert not dist.is_initialized()
    multihost.initialize("cpu")
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("method", ["sup", "plus_unsup", "unsup"])
def test_dist_trainer_matches_jax_trainer_at_world_1(world1, method,
                                                     tmp_path):
    """DistTrainer at world 1 against the JAX package's DistTrainer on a
    1-device mesh, from the JAX trainer's params, epoch by epoch through
    what ``fit`` runs (train_epoch, then evaluate, or for unsup the
    classifier fit every 2 epochs): the same RandomState draws the same
    host batches (BFS reorder, native frontiers, pair batches), so each
    epoch's mean loss agrees within rtol 1e-4 and the params after it
    within atol 5e-4 (f32 sums in other orders over 12 clipped steps at lr
    0.3; plus_unsup, whose loss rises in its second epoch, ends its epochs
    3.8e-5 and 1.5e-4 apart from equal starts).  Each epoch then starts
    from JAX's params (lockstep: free-running, plus_unsup's 3.8e-5 grows
    to 3e-2 in one more epoch).  The val F1 history and the metrics events
    agree."""
    import json

    import torch

    from graphsage_tpu.models import GraphSageConfig as JCfg
    from graphsage_tpu.train.dist_trainer import (
        DistTrainConfig as JaxDistConfig, DistTrainer as JaxDistTrainer)
    from graphsage_torch.train import DistTrainConfig, DistTrainer

    ds = synthetic_power_law(400, 2000, num_feats=16, num_classes=4, seed=9)
    jds = jax_power_law(400, 2000, num_feats=16, num_classes=4, seed=9)
    kw = dict(learn_method=method, b_loc=16, epochs=2, lr=0.3, fanout=4,
              seed=1, clf_epochs=2, verbose=False, prefetch_depth=0)
    jtr = JaxDistTrainer(
        jds, JCfg(num_layers=2, input_size=16, out_size=16),
        JaxDistConfig(**kw, metrics_path=str(tmp_path / "jax.jsonl")),
        mesh=Mesh(np.asarray(jax.devices()[:1]), axis_names=("data",)))
    tr = DistTrainer(ds, GraphSageConfig(num_layers=2, input_size=16,
                                         out_size=16),
                     DistTrainConfig(**kw,
                                     metrics_path=str(tmp_path / "p.jsonl")),
                     params=jax.device_get(jtr.params), device="cpu")
    for epoch in range(2):
        jtr.epoch = tr.epoch = epoch
        np.testing.assert_allclose(tr.train_epoch(), jtr.train_epoch(),
                                   rtol=1e-4)
        want = jax.tree_util.tree_leaves(jax.device_get(jtr.params))
        with torch.no_grad():
            for a, b in zip(jax.tree_util.tree_leaves(tr.params), want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=5e-4)
                a.copy_(torch.from_numpy(np.array(b)))
        if method != "unsup":
            jtr.evaluate()
            tr.evaluate()
        elif epoch % 2 == 1:
            jtr.train_classification()
            tr.train_classification()
    assert ([h["val_f1"] for h in tr.history]
            == [h["val_f1"] for h in jtr.history])

    def events(path):
        with open(path) as f:
            return [json.loads(line)["event"] for line in f]

    assert events(tmp_path / "p.jsonl") == events(tmp_path / "jax.jsonl")


def test_dist_trainer_bf16_evaluates_as_jax_at_world_1(world1):
    """A bfloat16 DistTrainer at world 1 evaluates as the JAX package's
    DistTrainer on a 1-device mesh: both hold float32 master params and a
    float32 feature shard, and round them only inside the training loss.
    From the JAX trainer's params and the same RandomState, embed_nodes
    (the halo forward) agrees within rtol = atol = 1e-5, before and after
    one epoch (each trainer's own bfloat16 epoch, then the port takes
    JAX's params), and so does the val F1 of ``evaluate``."""
    import torch

    from graphsage_tpu.models import GraphSageConfig as JCfg
    from graphsage_tpu.train.dist_trainer import (
        DistTrainConfig as JaxDistConfig, DistTrainer as JaxDistTrainer)
    from graphsage_torch.train import DistTrainConfig, DistTrainer

    ds = synthetic_power_law(400, 2000, num_feats=16, num_classes=4, seed=9)
    jds = jax_power_law(400, 2000, num_feats=16, num_classes=4, seed=9)
    kw = dict(b_loc=16, epochs=1, lr=0.3, fanout=4, seed=1, verbose=False,
              prefetch_depth=0)
    mcfg = dict(num_layers=2, input_size=16, out_size=16,
                compute_dtype="bfloat16")
    jtr = JaxDistTrainer(
        jds, JCfg(**mcfg), JaxDistConfig(**kw),
        mesh=Mesh(np.asarray(jax.devices()[:1]), axis_names=("data",)))
    tr = DistTrainer(ds, GraphSageConfig(**mcfg), DistTrainConfig(**kw),
                     params=jax.device_get(jtr.params), device="cpu")
    val = ds.val_nodes
    np.testing.assert_allclose(tr.embed_nodes(val), jtr.embed_nodes(val),
                               rtol=FWD_TOL, atol=FWD_TOL)
    tr.train_epoch()
    jtr.train_epoch()
    with torch.no_grad():
        for a, b in zip(jax.tree_util.tree_leaves(tr.params),
                        jax.tree_util.tree_leaves(jax.device_get(
                            jtr.params))):
            a.copy_(torch.from_numpy(np.array(b)))
    np.testing.assert_allclose(tr.embed_nodes(val), jtr.embed_nodes(val),
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert tr.evaluate() == jtr.evaluate()
