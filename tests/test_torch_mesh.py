"""The port's ``data`` x ``model`` mesh (graphsage_torch.parallel.mesh), its
tensor-parallel dense step (``train.dense.make_dense_sup_step(mesh=...)``)
and ``entry.dryrun_multichip``, against the JAX package's
(graphsage_tpu.parallel.mesh, the GSPMD step of ``__graft_entry__.py``'s
``dryrun_multichip``), on the CPU.

The JAX side is ``jit`` over a (n_data, n_model) mesh of the virtual CPU
devices (tests/conftest.py forces 8), placed as ``__graft_entry__.py:107-127``
places it; the port side is gloo ranks, one process each
(tests/torch_dist_worker.py).  One launch a world size: P = 2 runs the
2 x 1 and 1 x 2 meshes, P = 4 the 2 x 2 mesh, each job forming its mesh
from the same world.  The step is the dry run's program 1 (512 nodes,
4096 edges, 64 features, 6 classes, out_size 32, fanout 10, a batch of
16·n_data), with JAX's params carried over (``params_from_jax``) and JAX's
draws of the global batch replayed on every rank.

- ``shard_params``: each rank's slices equal the ``addressable_shards`` of
  JAX's ``shard_params`` on the same device of the same mesh, exactly.
- One step against JAX's: loss rtol 1e-4 (JAX's own bar for the dry
  run), the params gathered back after the update atol 1e-5 (the port's
  float32 lockstep bar: the partial logits and the column slices' gradients
  add in another order).  Variants: MEAN with the clip inactive (lr 0.7,
  clip 5), MEAN with the clip active (lr 0.5, clip 0.05; a clip taken on
  the local slices' norm alone would pass at n_model 1 and fail at 2),
  MAX gcn with the clip active (the x0-gather branch), LSTM with the clip
  active (its cells are replicated over ``model`` and each model rank's
  gradient holds its slice's share: summed over the model group before
  the clip, their squares enter the norm once).
- The same step against the port's own single-device step on the whole
  batch, within the same bars.
- ``dryrun_multichip(2)`` and ``(4)`` pass their asserts over gloo.
- The checks that refuse a layout: ValueError for a hidden size or a batch
  that does not divide, and for a mesh that does not fit the group.
"""

import os
import subprocess
import sys

import __graft_entry__
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from graphsage_tpu.parallel import mesh as jmesh
from graphsage_tpu.train import dense as jd
from graphsage_torch.convert import flatten_params
from graphsage_torch.losses import supervised_nll
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.models.layers import classifier_apply
from graphsage_torch.parallel.mesh import Mesh, shard_params
from graphsage_torch.train import dense
from graphsage_torch.train.optim import global_norm, tree_leaves
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_cached import JaxHop, _t
from tests.torch_dist_worker import ROOT, ReplayHop, run_ranks

FANOUT = 10
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
# name: (agg_func, gcn, lr, clip)
VARIANTS = {"clip_off": ("MEAN", False, 0.7, 5.0),
            "clip_on": ("MEAN", False, 0.5, 0.05),
            "max_gcn": ("MAX", True, 0.7, 0.05),
            "lstm": ("LSTM", False, 0.7, 0.05)}
CASES = [(m, v) for m in MESHES for v in VARIANTS]
IDS = [f"{m}-{v}" for m, v in CASES]


class RecordingHop:
    def __init__(self, hop):
        self.hop, self.draws = hop, []

    def __call__(self, nodes, fanout):
        samples, valid = self.hop(nodes, fanout)
        self.draws.append((samples.numpy().copy(), valid.numpy().copy()))
        return samples, valid


def _setup(n_data: int, variant: str):
    """The dry run's program 1 (``__graft_entry__._tiny_setup``), with the
    variant's aggregator; JAX's params on the host."""
    agg, gcn, lr, clip = VARIANTS[variant]
    (jcfg, params, feats, neighbors, degrees, batch,
     labels) = __graft_entry__._tiny_setup(num_nodes=512, feat_dim=64,
                                           num_classes=6, batch=16 * n_data,
                                           edges=4096)
    if agg != "MEAN" or gcn:
        from graphsage_tpu.models import GraphSageConfig as JaxConfig
        from graphsage_tpu.models import init_graphsage
        from graphsage_tpu.models.layers import init_classifier

        jcfg = JaxConfig(num_layers=2, input_size=64, out_size=32,
                         agg_func=agg, gcn=gcn)
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        params = {"sage": init_graphsage(k1, jcfg),
                  "clf": init_classifier(k2, 32, 6)}
    return (jcfg, jax.device_get(params), feats, neighbors, degrees, batch,
            labels, lr, clip)


def _jax_step(mesh_name: str, variant: str):
    """JAX's GSPMD step on the mesh: (the mesh's devices in rank order, the
    sharded params, the new params on the host, the loss)."""
    n_data, n_model = MESHES[mesh_name]
    (jcfg, params, feats, neighbors, degrees, batch, labels, lr,
     clip) = _setup(n_data, variant)
    devices = jax.devices()[:n_data * n_model]
    mesh = JaxMesh(np.asarray(devices).reshape(n_data, n_model),
                   axis_names=("data", "model"))
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data"))
    params_sh = jmesh.shard_params(params, mesh)
    step = jax.jit(jd.make_dense_sup_step(jcfg, fanout=FANOUT, lr=lr,
                                          clip=clip))
    with mesh:
        new_params, loss = step(params_sh, jax.device_put(feats, repl),
                                jax.device_put(neighbors, repl),
                                jax.device_put(degrees, repl),
                                jax.device_put(batch, data_sh),
                                jax.device_put(labels, data_sh),
                                jax.random.PRNGKey(0))
    return devices, params_sh, jax.device_get(new_params), float(loss)


def _port_single(mesh_name: str, variant: str):
    """The port's single-device step on the whole batch, JAX's draws
    replayed (and recorded for the ranks): (draws, params after, loss,
    the per-model gradient norms)."""
    n_data, _ = MESHES[mesh_name]
    (jcfg, params, feats, neighbors, degrees, batch, labels, lr,
     clip) = _setup(n_data, variant)
    pad = type("Pad", (), {"neighbors": np.asarray(neighbors),
                           "degrees": np.asarray(degrees)})
    cfg = GraphSageConfig(**jcfg.__dict__)
    hop = RecordingHop(JaxHop(jax.random.split(jax.random.PRNGKey(0), 2),
                              pad))
    p = _leaf_params(params, CPU)
    loss = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=lr, clip=clip)(
        p, _t(feats), hop, _t(batch), _t(labels))
    # the gradient norms of the step, on the same draws
    q = _leaf_params(params, CPU)
    embs = dense.dense_forward(q, cfg, _t(feats), ReplayHop(hop.draws),
                               _t(batch), FANOUT)
    nll = supervised_nll(classifier_apply(q["clf"], embs), _t(labels),
                         torch.ones(len(batch)))
    norms = {k: float(global_norm(torch.autograd.grad(
        nll, tree_leaves(q[k]), retain_graph=True))) for k in ("sage", "clf")}
    return hop.draws, p, float(loss), norms


@pytest.fixture(scope="module")
def cases():
    """Every case's JAX step and the port's single-device step (computed in
    this process), and the ranks' jobs by world size."""
    out, jobs = {}, {2: [], 4: []}
    for mesh_name, variant in CASES:
        n_data, n_model = MESHES[mesh_name]
        (jcfg, params, feats, _, _, batch, labels, lr,
         clip) = _setup(n_data, variant)
        draws, single, single_loss, norms = _port_single(mesh_name, variant)
        out[mesh_name, variant] = {
            "jax": _jax_step(mesh_name, variant), "single": single,
            "single_loss": single_loss, "norms": norms, "clip": clip}
        jobs[n_data * n_model].append((f"{mesh_name}-{variant}", "mesh_step", {
            "cfg": dict(jcfg.__dict__), "params": params,
            "feats": np.asarray(feats), "batch": np.asarray(batch),
            "labels": np.asarray(labels), "draws": draws, "fanout": FANOUT,
            "lr": lr, "clip": clip, "n_data": n_data, "n_model": n_model}))
    return out, jobs


@pytest.fixture(scope="module")
def ranks(cases):
    """{world: [rank results]}: the steps of that world's meshes, then the
    make_mesh refusals (P = 2) and the dry run."""
    _, jobs = cases
    errors = ("errors", "mesh_errors",
              {"meshes": {"3x1": (3, 1), "1x3": (None, 3), "0x2": (0, 2)}})
    out = {}
    for world, steps in jobs.items():
        extra = [errors] if world == 2 else []
        out[world] = run_ranks(steps + extra + [("dryrun", "dryrun", {})],
                               world)
    return out


def _results(ranks, mesh_name, variant):
    n_data, n_model = MESHES[mesh_name]
    return [r[f"{mesh_name}-{variant}"] for r in ranks[n_data * n_model]]


def _assert_tree_close(got: dict, want, atol: float):
    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   rtol=0, atol=atol, err_msg=path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_make_mesh_lays_ranks_out_as_jax_reshape(ranks, mesh_name):
    """rank = d·n_model + m, JAX's ``reshape(n_data, n_model)``."""
    _, n_model = MESHES[mesh_name]
    for rank, res in enumerate(_results(ranks, mesh_name, "clip_off")):
        assert (res["data_rank"], res["model_rank"]) == divmod(rank,
                                                               n_model)


@pytest.mark.parametrize("mesh_name,variant", CASES, ids=IDS)
def test_shard_params_matches_jax_shards(cases, ranks, mesh_name, variant):
    devices, params_sh, _, _ = cases[0][mesh_name, variant]["jax"]
    want = flatten_params(params_sh)
    for rank, res in enumerate(_results(ranks, mesh_name, variant)):
        got = flatten_params(res["shards"])
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            shard, = [s for s in leaf.addressable_shards
                      if s.device == devices[rank]]
            np.testing.assert_array_equal(got[path], np.asarray(shard.data),
                                          err_msg=path)


@pytest.mark.parametrize("mesh_name,variant", CASES, ids=IDS)
def test_tensor_parallel_step_matches_jax(cases, ranks, mesh_name, variant):
    _, _, want, want_loss = cases[0][mesh_name, variant]["jax"]
    for res in _results(ranks, mesh_name, variant):
        np.testing.assert_allclose(res["loss"], want_loss, rtol=LOSS_RTOL)
        _assert_tree_close(res["gathered"], want, PARAM_ATOL)


@pytest.mark.parametrize("mesh_name,variant", CASES, ids=IDS)
def test_tensor_parallel_step_matches_the_single_device_step(
        cases, ranks, mesh_name, variant):
    case = cases[0][mesh_name, variant]
    single = jax.tree_util.tree_map(lambda x: x.detach().numpy(),
                                    case["single"])
    for res in _results(ranks, mesh_name, variant):
        np.testing.assert_allclose(res["loss"], case["single_loss"],
                                   rtol=LOSS_RTOL)
        _assert_tree_close(res["gathered"], single, PARAM_ATOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ranks_hold_one_model(ranks, mesh_name):
    """Every rank gathers the same params and reports the same loss; the
    ranks of one model column hold the same slices."""
    _, n_model = MESHES[mesh_name]
    res = _results(ranks, mesh_name, "clip_on")
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        for path, leaf in flatten_params(r["gathered"]).items():
            np.testing.assert_array_equal(
                leaf, flatten_params(res[0]["gathered"])[path])
    for rank, r in enumerate(res):
        twin = res[rank % n_model]
        for path, leaf in flatten_params(r["local"]).items():
            np.testing.assert_array_equal(
                leaf, flatten_params(twin["local"])[path])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_clip_cases_clip(cases, variant):
    """The clip is active where the case says so: both models' gradient
    norms exceed the clip (and stay under it in clip_off)."""
    for mesh_name in MESHES:
        case = cases[0][mesh_name, variant]
        for norm in case["norms"].values():
            assert (norm > case["clip"]) == (variant != "clip_off"), (
                mesh_name, case["norms"], case["clip"])


@pytest.mark.parametrize("world", [2, 4], ids=lambda w: f"P{w}")
def test_dryrun_multichip_passes_over_gloo(ranks, world):
    n_model = 2 if world >= 4 else 1
    for res in ranks[world]:
        lines = res["dryrun"]
        assert len(lines) == 4
        assert f"mesh=({world // n_model}x{n_model})" in lines[0]
        assert all(line.endswith("OK") for line in lines)


def test_make_mesh_refuses_a_mesh_that_does_not_fit(ranks):
    for res in ranks[2]:
        errors = res["errors"]
        assert "needs 3 ranks, the group has 2" in errors["3x1"]
        assert "n_model 3 does not divide the 2 ranks" in errors["1x3"]
        assert "needs 0 ranks" in errors["0x2"]


def _fake_mesh(n_data: int, n_model: int) -> Mesh:
    return Mesh(n_data=n_data, n_model=n_model, data_rank=0, model_rank=0,
                data_group=None, model_group=None)


def test_shard_params_refuses_an_indivisible_hidden_size():
    jcfg, params = _setup(1, "clip_off")[:2]
    with pytest.raises(ValueError, match="3 model ranks do not divide"):
        shard_params(_leaf_params(params, CPU), _fake_mesh(1, 3))


def test_sharded_step_refuses_an_indivisible_batch():
    (jcfg, params, feats, neighbors, degrees, batch, labels, _,
     _) = _setup(1, "clip_off")
    pad = type("Pad", (), {"neighbors": np.asarray(neighbors),
                           "degrees": np.asarray(degrees)})
    mesh = _fake_mesh(3, 1)
    step = dense.make_dense_sup_step(GraphSageConfig(**jcfg.__dict__),
                                     fanout=FANOUT, mesh=mesh)
    hop = JaxHop(jax.random.split(jax.random.PRNGKey(0), 2), pad)
    with pytest.raises(ValueError, match="do not divide over 3 data ranks"):
        step(shard_params(_leaf_params(params, CPU), mesh), _t(feats), hop,
             _t(batch), _t(labels))


def test_entry_module_runs_the_dry_run_at_world_1():
    """``python -m graphsage_torch.entry --device cpu``: entry()'s forward,
    then the four programs on a world of 1."""
    proc = subprocess.run(
        [sys.executable, "-m", "graphsage_torch.entry", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "entry forward: (16, 32)"
    assert len(lines) == 5 and "mesh=(1x1)" in lines[1]
    assert all(line.endswith("OK") for line in lines[1:])
