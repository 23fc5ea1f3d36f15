"""The port's sharded leaf-cached pipeline (graphsage_torch.train.cached_dist
and .cached_dist_trainer) against the JAX package's
(graphsage_tpu.train.cached_dist), on the CPU.

The JAX side is ``make_cached_dist_epoch`` / ``make_cached_dist_unsup_epoch``
under ``shard_map`` on the first P virtual CPU devices; the port side is P
gloo ranks (tests/torch_dist_worker.py) running ``local_refresh`` and
``cached_epoch_reuse`` over a ``CachedDistStep``, for P in {1, 2, 4}, on a
203-node graph (not a multiple of P: the tables are padded).

- Host stacks (``pad_node_tables``, ``build_epoch_stack``,
  ``build_unsup_epoch_stack``): bit-identical.
- Take-all sampling (fanout = the table's width, as
  tests/test_cached_dist.py:57 does), the port drawing from its own
  sampler: every draw is a whole row, whatever the generator, so the
  epochs must agree.  sup MEAN and sup MAX gcn, 3 steps.
- Real fanout (4 of up to 30) with the JAX draws replayed (the JAX
  package's keys: the refresh's ``fold_in(k_cache, rank)``, each step's
  ``fold_in(sub, rank)``): sup MEAN and plus_unsup MEAN in float32, 3
  steps; sup MEAN in bfloat16, 1 step.
- The pmean trap: the take-all epoch on P ranks equals the port's own
  single-device cached epoch on the concatenated [T, P·b_loc] batches.
- The padded tail: rows with row_mask 0 change nothing (bit for bit).

Tolerances: float32, one step: loss rtol 1e-5, params atol 1e-6; an epoch
of 3 steps at lr 0.7 (each step's last-bit differences, from sums in
other orders, feed the next): losses rtol 1e-5, params atol 1e-5; bfloat16
one step: tests/test_torch_bf16.py's bars.
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
from graphsage_tpu.sampler import PairSampler as JaxPairSampler
from graphsage_tpu.sampler.device import _sample_one_hop as jax_one_hop
from graphsage_tpu.train import cached_dist as jcd
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.sampler import PairSampler
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import cached, cached_dist
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_bf16 import assert_step_close
from tests.torch_dist_worker import run_ranks

N, D, H, C, B_LOC, T, FANOUT, LR = 203, 24, 16, 4, 4, 3, 4, 0.7
STEP_RTOL, STEP_ATOL, EPOCH_ATOL = 1e-5, 1e-6, 1e-5
CPU = torch.device("cpu")

# name: (learn_method, agg_func, gcn, compute_dtype, take-all, steps)
EPOCHS = {"takeall": ("sup", "MEAN", False, "float32", True, T),
          "takeall_max_gcn": ("sup", "MAX", True, "float32", True, T),
          "replay": ("sup", "MEAN", False, "float32", False, T),
          "replay_step": ("sup", "MEAN", False, "float32", False, 1),
          "replay_plus_unsup": ("plus_unsup", "MEAN", False, "float32",
                                False, T),
          "replay_bf16": ("sup", "MEAN", False, "bfloat16", False, 1)}


def _jcfg(agg="MEAN", gcn=False, dtype="float32"):
    return JaxConfig(num_layers=2, input_size=D, out_size=H, agg_func=agg,
                     gcn=gcn, compute_dtype=dtype)


def _params(jcfg):
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    return jax.device_get({"sage": jax_init_graphsage(k1, jcfg),
                           "clf": jax_init_clf(k2, H, C)})


@pytest.fixture(scope="module")
def data():
    ds = synthetic_power_law(N, 6 * N, num_feats=D, num_classes=C, seed=3)
    jds = jax_power_law(N, 6 * N, num_feats=D, num_classes=C, seed=3)
    return ds, jds, ds.graph.to_padded()


def _tables(ds, pad, world):
    return cached_dist.pad_node_tables(ds.features, pad.neighbors,
                                       pad.degrees, world)


def _jax_draws(key, tables, batches, world, fanout):
    """Rank r's draws of the JAX epoch in the order the port's step takes
    them: the refresh's, then each step's one frontier hop."""
    feats, neighbors, degrees = tables
    nb, deg = jnp.asarray(neighbors), jnp.asarray(degrees)
    rows_per = feats.shape[0] // world
    k_cache, k_steps = jax.random.split(key)
    keys = [[] for _ in range(world)]
    k = k_steps
    for _ in range(batches.shape[0]):
        k, sub = jax.random.split(k)
        for r in range(world):
            keys[r].append(jax.random.split(jax.random.fold_in(sub, r),
                                            1)[0])
    draws = []
    for r in range(world):
        ids = jnp.arange(r * rows_per, (r + 1) * rows_per, dtype=jnp.int32)
        rank = [jax_one_hop(jax.random.fold_in(k_cache, r), nb, deg, ids,
                            fanout)]
        rank += [jax_one_hop(kk, nb, deg, jnp.asarray(batches[t, r]),
                             fanout) for t, kk in enumerate(keys[r])]
        draws.append([(np.asarray(s), np.asarray(v)) for s, v in rank])
    return draws


def _stacks(ds, jds, world, method, steps):
    rng, jrng = np.random.RandomState(0), np.random.RandomState(0)
    b = world * B_LOC
    if method == "sup":
        stack = cached_dist.build_epoch_stack(ds.train_nodes, ds.labels,
                                              world, b, rng)
        jstack = jcd.build_epoch_stack(jds.train_nodes, jds.labels, world,
                                       b, jrng)
        return [a[:steps] for a in stack], [a[:steps] for a in jstack], None
    ps = PairSampler(ds.graph, ds.train_nodes, negative_mode="exact")
    jps = JaxPairSampler(jds.graph, jds.train_nodes, negative_mode="exact")
    *stack, pairs = cached_dist.build_unsup_epoch_stack(
        ps, ds.train_nodes[:steps * b], ds.labels, world, b, 100, rng)
    *jstack, jpairs = jcd.build_unsup_epoch_stack(
        jps, jds.train_nodes[:steps * b], jds.labels, world, b, 100, jrng)
    return stack, [np.asarray(a) for a in jstack], (pairs, jpairs)


def _jax_epoch(name, world, tables, jstack, jpairs, params, fanout, key):
    method, agg, gcn, dtype = EPOCHS[name][:4]
    jcfg = _jcfg(agg, gcn, dtype)
    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data",))
    feats, nb, deg = tables
    if dtype == "bfloat16":
        feats = jnp.asarray(feats, dtype=jnp.bfloat16)
    args = jcd.place_epoch_inputs(mesh, feats, nb, deg, *jstack)
    p = jax.device_put(params, NamedSharding(mesh, P()))
    if method == "sup":
        fn = jcd.make_cached_dist_epoch(jcfg, mesh, fanout=fanout, lr=LR)
        new, losses = fn(p, *args, key)
    else:
        fn = jcd.make_cached_dist_unsup_epoch(jcfg, mesh, fanout=fanout,
                                              lr=LR, learn_method=method)
        pairs = {k: jax.device_put(jnp.asarray(v),
                                   NamedSharding(mesh, P(None, "data")))
                 for k, v in jpairs.items()}
        new, losses = fn(p, *args, pairs, key)
    return np.asarray(losses), jax.device_get(new)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def epochs(request, data):
    world = request.param
    ds, jds, pad = data
    tables = _tables(ds, pad, world)
    key = jax.random.PRNGKey(42)
    jobs, refs = [], {}
    for name, (method, agg, gcn, dtype, takeall, steps) in EPOCHS.items():
        fanout = pad.width if takeall else FANOUT
        stack, jstack, pairs = _stacks(ds, jds, world, method, steps)
        params = _params(_jcfg(agg, gcn, dtype))
        draws = None if takeall else _jax_draws(key, tables, stack[0],
                                                world, fanout)
        refs[name] = (jstack, pairs and pairs[1], params, fanout)
        jobs.append((name, "cached_epoch", dict(
            cfg=dataclasses.asdict(_jcfg(agg, gcn, dtype)), params=params,
            feats=tables[0], neighbors=tables[1], degrees=tables[2],
            stack=stack, pairs=pairs and pairs[0], draws=draws,
            sampler_seed=11, learn_method=method, fanout=fanout, lr=LR,
            clip=5.0)))
    # the padded tail: the first 4P+5 train nodes, one junk-label copy
    stack = cached_dist.build_epoch_stack(
        ds.train_nodes[:4 * world + 5], ds.labels, world, 4 * world,
        np.random.RandomState(3))
    junk = stack[1].copy()
    junk[stack[2] == 0] = (junk[stack[2] == 0] + 1) % C
    for name, labels in (("tail", stack[1]), ("tail_junk", junk)):
        jobs.append((name, "cached_epoch", {
            **jobs[0][2], "stack": [stack[0], labels, stack[2]]}))
    out = run_ranks(jobs, world)
    return dict(world=world, tables=tables, refs=refs, out=out, key=key,
                jobs=dict((n, p) for n, _, p in jobs))


def test_host_stacks_equal_jax(data):
    ds, jds, pad = data
    for world in (1, 2, 4, 8):
        for a, b in zip(_tables(ds, pad, world),
                        jcd.pad_node_tables(jds.features, pad.neighbors,
                                            pad.degrees, world)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        stack, jstack, _ = _stacks(ds, jds, world, "sup", None)
        for a, b in zip(stack, jstack):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    stack, jstack, (pairs, jpairs) = _stacks(ds, jds, 2, "plus_unsup", 3)
    for a, b in zip(stack, jstack):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in cached_dist.PAIR_FIELDS:
        np.testing.assert_array_equal(pairs[k], np.asarray(jpairs[k]))


@pytest.mark.parametrize("name", list(EPOCHS))
def test_cached_dist_epoch_matches_jax(epochs, name):
    world = epochs["world"]
    jstack, jpairs, params, fanout = epochs["refs"][name]
    want_losses, want = _jax_epoch(name, world, epochs["tables"], jstack,
                                   jpairs, params, fanout, epochs["key"])
    got = epochs["out"][0][name]
    if EPOCHS[name][3] == "bfloat16":
        assert_step_close(name, got["losses"][0], want_losses[0], params,
                          got["params"], want)
        return
    atol = STEP_ATOL if EPOCHS[name][5] == 1 else EPOCH_ATOL
    np.testing.assert_allclose(got["losses"], want_losses, rtol=STEP_RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def test_ranks_hold_identical_params(epochs):
    out = epochs["out"]
    for name in EPOCHS:
        for r in range(1, epochs["world"]):
            np.testing.assert_array_equal(out[r][name]["losses"],
                                          out[0][name]["losses"])
            for a, b in zip(jax.tree_util.tree_leaves(out[r][name]["params"]),
                            jax.tree_util.tree_leaves(out[0][name]["params"])):
                np.testing.assert_array_equal(a, b)


def test_epoch_equals_single_device_epoch_on_concatenated_batches(epochs):
    """The pmean trap: the take-all epoch on P ranks == the port's own
    single-device cached epoch over the same rows, concatenated."""
    p = epochs["jobs"]["takeall"]
    cfg = GraphSageConfig(**p["cfg"])
    params = _leaf_params(p["params"], CPU)
    feats = torch.from_numpy(p["feats"])
    nb, deg = torch.from_numpy(p["neighbors"]), torch.from_numpy(
        p["degrees"])
    hop = HopSampler(nb, deg, torch.Generator().manual_seed(0))
    cache = cached.refresh_leaf_cache(hop, feats, p["fanout"])
    step = cached.CachedStep(cfg, fanout=p["fanout"], lr=LR)
    batches, labels, masks = (torch.from_numpy(a.reshape(a.shape[0], -1))
                              for a in p["stack"])
    losses = cached.cached_epoch_reuse(step, params, feats, *cache, hop,
                                       batches, labels, masks)
    got = epochs["out"][0]["takeall"]
    np.testing.assert_allclose(got["losses"], losses.numpy(),
                               rtol=STEP_RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0,
                                   atol=EPOCH_ATOL)


def test_local_refresh_is_the_rank_rows_of_the_full_refresh(epochs):
    """Under take-all, each rank's cache is its rows of the one-shot
    refresh of every row (MEAN up to the sum order, counts exact)."""
    p = epochs["jobs"]["takeall"]
    nb, deg = torch.from_numpy(p["neighbors"]), torch.from_numpy(
        p["degrees"])
    hop = HopSampler(nb, deg, torch.Generator().manual_seed(0))
    full, cnt = cached.refresh_leaf_cache(hop, torch.from_numpy(p["feats"]),
                                          p["fanout"])
    rows = full.shape[0] // epochs["world"]
    for r, res in enumerate(epochs["out"]):
        got = res["takeall"]
        np.testing.assert_allclose(got["cache"],
                                   full[r * rows:(r + 1) * rows].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["count"],
                                      cnt[r * rows:(r + 1) * rows].numpy())


def test_padded_tail_rows_change_nothing(epochs):
    out = epochs["out"]
    for r in range(epochs["world"]):
        a, b = out[r]["tail"], out[r]["tail_junk"]
        np.testing.assert_array_equal(a["losses"], b["losses"])
        for x, y in zip(jax.tree_util.tree_leaves(a["params"]),
                        jax.tree_util.tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)


def test_cli_cached_dist_two_ranks_export_and_resume(tmp_path):
    from tests.test_torch_distributed import check_cli_resume

    check_cli_resume("cached_dist", ["--table_cap", "8", "--no_extend"],
                     tmp_path)


@pytest.mark.parametrize("method", ["unsup", "plus_unsup"])
def test_cli_cached_dist_two_ranks_unsupervised(method, tmp_path):
    from tests.test_torch_distributed import check_cli_unsup

    check_cli_unsup("cached_dist", ["--table_cap", "8", "--learn_method",
                                    method], tmp_path)
