"""The port's anatomy tools (graphsage_torch.step_anatomy, .profile_cached,
.profile_unsup) against the JAX system's tools/step_anatomy.py,
tools/profile_cached.py and tools/profile_unsup.py, on the CPU, at small
sizes (2,000 nodes, 16 features, hidden 8, batch 64, 2 reps):

- the record keys and row names of the JAX tools, captured by running
  them on the small graph with their timers replaced by recorders (the
  JAX ``anatomy()`` called directly, the other two tools' ``main()`` in a
  temporary working directory, so that no file of the repository is
  written), and the derived slices on the same slice times;
- every program a module times against what the JAX tool's program
  computes, on the same inputs (params copied with ``convert.py``), with
  JAX's draws replayed (``JaxHop``): float32 values rtol 1e-4 (atol 1e-4),
  bfloat16 losses rtol 1e-2 and other values (outputs, gradients,
  updates) within 2e-2 of their largest element; row gathers and the
  sampled frontiers exactly;
- no card, no run; ``main`` writes only under ``--out``.
"""

import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphsage_tpu.data as jax_data
import graphsage_tpu.ops.sddmm as jax_sddmm
import graphsage_tpu.train.cached as jc
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models.layers import sage_layer_apply as jax_layer
from graphsage_tpu.sampler.device import sample_frontiers_dense as jax_sample
from graphsage_torch import bench, profile_cached, profile_unsup, step_anatomy
from graphsage_torch.bigscale_bench import write_merged
from graphsage_torch.convert import flatten_params
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train.trainer import _leaf_params
from tests.test_bench_registry import _load_bench
from tests.test_torch_bench import _jax_keys
from tests.test_torch_bigscale import (B, CPU, D, H, N, _check, _clock,
                                       _load_tool, _tt, graphs)  # noqa: F401
from tests.test_torch_cached import JaxHop, _t

REPS = 2
# the JAX tool's scanned slices in the order it times them, each given a
# time a call (ms); its step takes 0.5 s of the patched clock over REPS
SLICE_MS = {"timing_floor": 1.0, "sampling": 2.0, "l1_gemm": 3.0,
            "l1_gemm_plus_gather": 5.5, "fwd": 9.0, "fwd_bwd": 20.0,
            "scatter_bound": 7.0, "gather_bound": 4.0}
STEP_MS = 0.5 / REPS * 1e3
ANATOMY_EXTRAS = {"launches", "step_profile"}
ROW_EXTRAS = ANATOMY_EXTRAS | {"device", "power_limit"}


def _port_cfg(dtype):
    return GraphSageConfig(num_layers=2, input_size=D, out_size=H,
                           compute_dtype=dtype)


def _jax_cfg(dtype):
    return JaxConfig(num_layers=2, input_size=D, out_size=H,
                     compute_dtype=dtype)


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32))


def _close(dtype, got, want, exact=False):
    """got (torch) against want (JAX) at the dtype's bar."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max() + 1e-12


def _hop_keys(keys):
    """The hop keys of cached_forward calls on ``keys``: split(k, 1)[0]."""
    return [jax.random.split(k, 1)[0] for k in keys]


# ------------------------------------------------------------ step_anatomy

@pytest.fixture(scope="module")
def jax_anatomy(graphs):
    """The JAX tool's record on the small graph and the slices it timed:
    {body name: (body, its arrays)}, and its jitted full_steps."""
    jds, jpad = graphs[:2]
    mp = pytest.MonkeyPatch()
    slices, jitted = {}, {}
    order = iter(SLICE_MS.values())
    real_jit = jax.jit

    def scan_timed(make_body, arrays=(), reps=None):
        slices[make_body.__name__] = (make_body, arrays)
        return next(order), 0.0

    def recording_jit(fn, *a, **k):
        out = real_jit(fn, *a, **k)
        jitted[fn.__name__] = out
        return out

    try:
        mp.setitem(sys.modules, "bench", _load_bench())
        tool = _load_tool("step_anatomy")
        mp.setattr(tool, "_scan_timed", scan_timed)
        mp.setattr(tool, "REPS", REPS)
        mp.setattr(tool, "time", _clock())
        mp.setattr(jax, "jit", recording_jit)
        res = tool.anatomy(jds, jpad, B, hidden=H)
    finally:
        mp.undo()
    return res, slices, jitted["full_steps"]


@pytest.fixture(scope="module")
def port_anatomy(graphs):
    _, _, ds, pad = graphs
    times = iter([STEP_MS if s == "step" else SLICE_MS[s]
                  for s in step_anatomy.SLICES])
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(step_anatomy, "REPS", REPS)
        mp.setattr(step_anatomy, "timed_ms",
                   lambda fn, dev, reps: (next(times), {}))
        return step_anatomy.anatomy(ds, pad, B, CPU, hidden=H,
                                    log=lambda *a: None)
    finally:
        mp.undo()


def test_anatomy_record_and_derived_equal_the_jax_tool(jax_anatomy,
                                                       port_anatomy):
    """The keys (the JAX tool's and the port's two extras), the sizes, and
    every slice and derived slice from the same slice times."""
    want, got = jax_anatomy[0], port_anatomy
    assert set(got) - set(want) == ANATOMY_EXTRAS
    assert set(want) <= set(got)
    for key in ("batch", "nodes", "frontier_rows", "dtype"):
        assert got[key] == want[key], key
    assert want["step_ms"] == STEP_MS
    for key, value in want.items():
        if key.endswith("_ms"):
            assert abs(got[key] - value) <= 1e-3, key
        elif key.endswith("_per_sec"):
            assert got[key] == pytest.approx(value, abs=0.05), key
    assert step_anatomy.derived(got) == {
        k: got[k] for k in ("upper_plus_head_fwd_ms", "backward_ms",
                            "opt_ms")}
    assert set(got["launches"]) == set(step_anatomy.SLICES)
    assert got["step_profile"]["device_busy_ms"] is None


def _anatomy_programs(graphs, jax_anatomy, keys, table=None, dout=None):
    """(the port's slice programs on the JAX tool's arrays, its draws from
    ``keys`` replayed; the port's copy of the params they update)."""
    slices = jax_anatomy[1]
    params, feats, cf, cc, _, _, bids, lab = slices["s_fwd"][1]
    ids = slices["s_l1_gather"][1][3]
    port_params = _leaf_params(jax.device_get(params), CPU)
    return step_anatomy.slice_programs(
        _port_cfg("bfloat16"), port_params, _tt(feats), _tt(cf), _tt(cc),
        JaxHop(keys, graphs[1]), _t(bids), _t(lab), _t(ids), table,
        dout), port_params


def _rand(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, jnp.dtype(dtype).name))


@pytest.mark.parametrize("program", [s for s in step_anatomy.SLICES
                                     if s != "timing_floor"])
def test_anatomy_programs_equal_the_jax_slices(graphs, jax_anatomy,
                                               program):
    """Each slice's program against what the JAX slice computes at its
    iteration 1 (the step: its REPS scanned steps), bfloat16."""
    _, slices, full_steps = jax_anatomy
    env = inspect.getclosurevars(slices["s_fwd"][0]).nonlocals
    key0, jcfg = env["key0"], env["mcfg"]
    k1 = jax.random.fold_in(key0, 1)
    fwd_args = slices["s_fwd"][1]
    params, feats, cf, cc, nb, dg, bids, lab = fwd_args
    w1, cfeats, ccache, ids = slices["s_l1_gather"][1]
    if program == "sampling":
        got_ids, got_fr = _anatomy_programs(graphs, jax_anatomy,
                                            _hop_keys([k1]))[0]["sampling"]()
        want_ids, want_fr = jax_sample(k1, nb, dg, bids, num_layers=1,
                                       fanout=10)
        _close("bfloat16", got_ids, want_ids, exact=True)
        _close("bfloat16", got_fr[0].mask, want_fr[0].mask, exact=True)
        body, arrays = slices["s_sampling"]
        assert float(body(1, jnp.float32(0), *arrays)) == pytest.approx(
            (float(jnp.sum(want_ids)) + float(jnp.sum(want_fr[0].mask)))
            * 1e-20, rel=1e-6)
    elif program in ("l1_gemm", "l1_gemm_plus_gather"):
        want = jax_layer(w1, cfeats, ccache, gcn=False)
        body, arrays = slices["s_l1"]
        assert float(body(1, jnp.float32(0), *arrays)) == pytest.approx(
            float(jnp.sum(want.astype(jnp.float32))) * 1e-20, rel=1e-5)
        if program == "l1_gemm_plus_gather":
            want = jnp.take(want, ids, axis=0)
        got = _anatomy_programs(graphs, jax_anatomy, [])[0][program]()
        _close("bfloat16", got, want)
    elif program == "fwd":
        got = _anatomy_programs(graphs, jax_anatomy,
                                _hop_keys([k1]))[0]["fwd"]()
        body = slices["s_fwd"][0]
        want = float(body(1, jnp.float32(0), *fwd_args)) / 1e-20
        np.testing.assert_allclose(float(got), want, rtol=1e-2)
    elif program == "fwd_bwd":
        progs, port_params = _anatomy_programs(graphs, jax_anatomy,
                                               _hop_keys([k1]))
        got_loss, got_grads = progs["fwd_bwd"]()
        want_loss, want_grads = _jax_sup_value_and_grad(jcfg, fwd_args, k1)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-2)
        want_flat = flatten_params(want_grads)
        for path, g in zip(flatten_params(port_params), got_grads):
            _close("bfloat16", g, want_flat[path])
    elif program == "step":
        keys = [jax.random.fold_in(key0, it) for it in range(REPS)]
        progs, port_params = _anatomy_programs(graphs, jax_anatomy,
                                               _hop_keys(keys))
        losses = torch.stack([progs["step"]() for _ in range(REPS)])
        want_losses = full_steps(params, *fwd_args[1:])
        step = jax.jit(jc.make_cached_sup_step(jcfg, fanout=10))
        want_p = params
        for k in keys:
            want_p, _ = step(want_p, *fwd_args[1:], k)
        _check("bfloat16", losses, want_losses, port_params, want_p, params)
    else:
        table_j, table_t = _rand((N, H), jnp.bfloat16, 3)
        dout_j, dout_t = _rand((ids.shape[0], H), jnp.bfloat16, 4)
        got = _anatomy_programs(graphs, jax_anatomy, [], table_t,
                                dout_t)[0][program]()
        if program == "gather_bound":
            want = jnp.take(table_j, ids, axis=0)
        else:
            want = jax.grad(lambda tt: jnp.sum(
                jnp.take(tt, ids, axis=0).astype(jnp.float32)
                * dout_j.astype(jnp.float32)))(jnp.zeros_like(table_j))
        # JAX adds the bfloat16 contributions in index order, as
        # ops/scatter.py does: equal bit for bit
        _close("bfloat16", got, want, exact=True)


def _jax_sup_value_and_grad(jcfg, fwd_args, key):
    """The JAX tool's s_fwd_bwd body without its checksum: the loss and
    the gradient of every param."""
    from graphsage_tpu.losses import supervised_nll
    from graphsage_tpu.models import classifier_apply
    from graphsage_tpu.train.dense import cast_compute

    params, feats, cf, cc, nb, dg, bids, lab = fwd_args

    def loss_of(p):
        embs = jc.cached_forward(p, jcfg, feats, cf, cc, nb, dg, bids, key,
                                 10)
        logp = classifier_apply(cast_compute(p["clf"], jcfg), embs)
        return supervised_nll(logp, lab,
                              jnp.ones(bids.shape[0], jnp.float32))

    return jax.value_and_grad(loss_of)(params)


# ------------------------------------------------------------ profile_cached

@pytest.fixture(scope="module")
def jax_cached(graphs, tmp_path_factory):
    """The JAX tool's PROFILE_CACHED.json on the small graph and, by row,
    the jitted program and arguments it timed."""
    jds = graphs[0]
    mp = pytest.MonkeyPatch()
    timed = []

    def dev_time(program, *args):
        # traced now, while the loop's config and the patched constants
        # hold: the programs the tests run
        if program.__name__ in ("step_many", "scatter_many", "segsum_many"):
            program = program.lower(*args).compile()
        timed.append((program, args))
        return float(len(timed))

    try:
        mp.chdir(tmp_path_factory.mktemp("jax_cached"))
        tool = _load_tool("profile_cached")
        mp.setattr(tool, "synthetic_power_law", lambda *a, **k: jds)
        for name, value in (("B", B), ("HIDDEN", H), ("ITERS", REPS),
                            ("dev_time", dev_time)):
            mp.setattr(tool, name, value)
        tool.main()
        with open("PROFILE_CACHED.json") as f:
            record = json.load(f)
    finally:
        mp.undo()
    return record, {row["op"]: t for row, t in zip(record["rows"], timed)}


@pytest.fixture
def small_cached(monkeypatch):
    for name, value in (("B", B), ("HIDDEN", H), ("ITERS", REPS)):
        monkeypatch.setattr(profile_cached, name, value)


def test_cached_record_equals_the_jax_tool(graphs, jax_cached,
                                           small_cached):
    want = jax_cached[0]
    _, _, ds, pad = graphs
    got = profile_cached.run(ds, pad, CPU, log=lambda *a: None)
    assert set(got) - set(want) == {"power_limit"}
    assert set(want) <= set(got)
    assert [r["op"] for r in got["rows"]] == [r["op"] for r in want["rows"]]
    m = B * 11
    for row, jrow in zip(got["rows"], want["rows"]):
        assert set(row) == set(jrow) | {"launches"}
        assert np.isfinite(row["ms"]) and row["ms"] > 0
        if jrow["detail"]:
            assert row["detail"].startswith(
                f"{m / row['ms'] * 1000 / 1e6:.0f}M rows/s; ")
    details = {r["op"]: r["detail"] for r in got["rows"]}
    assert "scatter_rows" in details[f"scatter_add_{m}x{H}_bfloat16"]
    assert "index_add_" in details[f"scatter_add_{m}x{H}_float32"]
    assert "torch.sort" in details[f"sort_segsum_{m}x{H}_float32"]


def _cached_inputs(jax_cached, dtype, keys_of):
    """The port's per-dtype programs on the JAX tool's step arguments,
    its draws (``keys_of(keys)``) replayed; also those arguments."""
    program, args = jax_cached[1][f"full_step_{dtype}"]
    params, feats, mf, cc, nb, dg, batch, labels, keys = args
    pad = type("Pad", (), {"neighbors": np.asarray(nb),
                           "degrees": np.asarray(dg)})
    port_params = _leaf_params(jax.device_get(params), CPU)
    hop = JaxHop(keys_of(keys), pad)
    programs = profile_cached.step_programs(
        _port_cfg(dtype), port_params, _t(feats), _t(mf), _t(cc), hop,
        _t(batch), _t(labels))
    return programs, port_params, hop, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("program", ["refresh", "full_step", "forward_only",
                                     "fwd_bwd", "gemm"])
def test_cached_step_programs_equal_the_jax_tool(jax_cached, small_cached,
                                                 program, dtype):
    """Each per-dtype row's program against the JAX tool's: the steps
    against its scanned program (losses and params); the others'
    last iteration against what its body computes there."""
    keys_of = {"refresh": list, "gemm": lambda keys: []}.get(program,
                                                             _hop_keys)
    programs, port_params, hop, args = _cached_inputs(jax_cached, dtype,
                                                      keys_of)
    params, feats, mf, cc, nb, dg, batch, labels, keys = args
    jcfg = _jax_cfg(dtype)
    got = programs[program]()
    assert not hop.keys
    if program == "refresh":
        want = jc.refresh_leaf_cache(keys[-1], feats, nb, dg, 10)
        _close("float32", got[0], want[0])
        _close("float32", got[1], want[1], exact=True)
    elif program == "full_step":
        want_p, want_l = jax_cached[1][f"full_step_{dtype}"][0](*args)
        _check(dtype, got, want_l, port_params, want_p, params)
    elif program == "forward_only":
        _close(dtype, got, jc.cached_forward(params, jcfg, feats, mf, cc,
                                             nb, dg, batch, keys[-1], 10))
    elif program == "fwd_bwd":
        loss, grads = jax.value_and_grad(lambda p: jnp.sum(
            jc.cached_forward(p, jcfg, feats, mf, cc, nb, dg, batch,
                              keys[-1], 10).astype(jnp.float32)))(params)
        np.testing.assert_allclose(float(got[0]), float(loss),
                                   rtol=1e-4 if dtype == "float32" else 1e-2)
        want = flatten_params(grads)
        for path, g in zip(flatten_params(port_params), got[1]):
            if path.startswith("sage"):
                _close(dtype, g, want[path])
    else:
        cd = jnp.dtype(dtype)
        w = jax.tree_util.tree_map(lambda x: x.astype(cd),
                                   params["sage"]["layers"][0])
        _close(dtype, got, jax_layer(w, feats.astype(cd), mf.astype(cd)))


def test_cached_sampling_program_equals_the_jax_tool(jax_cached,
                                                     small_cached):
    _, args = jax_cached[1]["sampling_L-1_hops"]
    nb, dg, batch, keys = args
    pad = type("Pad", (), {"neighbors": np.asarray(nb),
                           "degrees": np.asarray(dg)})
    hop = JaxHop(_hop_keys(keys), pad)
    ids, frontiers = profile_cached.sampling_program(
        _port_cfg("float32"), hop, _t(batch))()
    want_ids, want_fr = jax_sample(keys[-1], nb, dg, batch, num_layers=1,
                                   fanout=10)
    _close("float32", ids, want_ids, exact=True)
    _close("float32", frontiers[0].mask, want_fr[0].mask, exact=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("program", ["gather", "scatter_add",
                                     "sort_segsum"])
def test_cached_movement_programs_equal_the_jax_tool(jax_cached,
                                                     small_cached, program,
                                                     dtype):
    """At the tool's rolled ids (``uniform_ids`` equal to them), on a
    random table and random values: the gather's last iteration against
    ``jnp.take``; the carried table against the tool's scanned
    program."""
    m = B * 11
    jprogram, (table, ids, *_) = jax_cached[1][f"{program}_{m}x{H}_{dtype}"]
    np.testing.assert_array_equal(profile_cached.uniform_ids(N, m),
                                  np.asarray(ids))
    table_j, table_t = _rand((N, H), jnp.dtype(dtype), 5)
    values_j, values_t = _rand((m, H), jnp.dtype(dtype), 6)
    got = profile_cached.movement_programs(table_t, _t(ids),
                                           values_t)[program]()
    if program == "gather":
        want = jnp.take(table_j, (ids + REPS - 1) % N, axis=0)
        _close(dtype, got, want, exact=True)
    else:
        _close(dtype, got, jprogram(table_j, ids, values_j))


# ------------------------------------------------------------ profile_unsup

SMALL_UNSUP = {"U": 256, "B": 32, "P": 6, "M": 20, "H": H, "STEPS": REPS,
               "REPS": REPS}


@pytest.fixture(scope="module")
def jax_unsup(graphs, tmp_path_factory):
    """The JAX tool's PROFILE_UNSUP.json on the small graph (its Pallas
    kernel in interpret mode) and, in order, the programs and arguments it
    timed."""
    jds = graphs[0]
    mp = pytest.MonkeyPatch()
    timed = []
    pallas = jax_sddmm.pallas_pair_scores

    def timeit(fn, *args):
        # traced now, while the patched constants and kernel hold
        if hasattr(fn, "lower"):
            fn = fn.lower(*args).compile()
        timed.append((fn, args))
        return 1e-3 * len(timed)

    try:
        mp.chdir(tmp_path_factory.mktemp("jax_unsup"))
        mp.setitem(sys.modules, "bench", _load_bench())
        tool = _load_tool("profile_unsup")
        for name, value in (*SMALL_UNSUP.items(), ("_timeit", timeit)):
            mp.setattr(tool, name, value)
        mp.setattr(jax_data, "synthetic_power_law", lambda *a, **k: jds)
        mp.setattr(jax_sddmm, "pallas_pair_scores",
                   lambda e, t, eps=1e-8, interpret=None: pallas(
                       e, t, eps=eps, interpret=True))
        tool.main()
        with open("PROFILE_UNSUP.json") as f:
            record = json.load(f)
        return record, timed, tool.make_pairs(np.random.RandomState(3))
    finally:
        mp.undo()


@pytest.fixture
def small_unsup(monkeypatch):
    for name, value in SMALL_UNSUP.items():
        monkeypatch.setattr(profile_unsup, name, value)


def test_unsup_record_equals_the_jax_tool(graphs, jax_unsup, small_unsup):
    want = jax_unsup[0]
    _, _, ds, pad = graphs
    got = profile_unsup.run(ds, pad, CPU, log=lambda *a: None)
    assert set(got) - set(want) == {"power_limit", "launches"}
    assert set(want) <= set(got)
    assert got["shape"] == want["shape"]
    for variant in ("sddmm_pallas", "gathered"):
        assert set(got[f"parity_{variant}"]) == {"dloss", "dgrad_max"}
    assert set(got["launches"]) == {k for k in got if k.endswith("_ms")}
    for key in got["launches"]:
        assert np.isfinite(got[key]) and got[key] > 0


def test_unsup_inputs_equal_the_jax_tool(jax_unsup, small_unsup):
    """The pairs and the embeddings from one RandomState(3)."""
    pairs, emb = profile_unsup.block_inputs(CPU)
    want_pairs = jax_unsup[2]
    assert set(pairs) == set(want_pairs)
    for k, v in want_pairs.items():
        np.testing.assert_array_equal(pairs[k].numpy(), np.asarray(v))
    (_, (want_emb,)) = jax_unsup[1][0]
    _close("bfloat16", emb, want_emb, exact=True)


@pytest.mark.parametrize("variant", profile_unsup.VARIANTS)
def test_unsup_blocks_equal_the_jax_tool(jax_unsup, small_unsup, variant):
    """Each block's loss and gradient against the JAX tool's (bfloat16),
    and the three blocks within the same bars of one another."""
    fn, (emb_j,) = jax_unsup[1][profile_unsup.VARIANTS.index(variant)]
    pairs, emb = profile_unsup.block_inputs(CPU)
    loss, grad = profile_unsup.block_fn(variant, pairs)(emb)
    want_loss, want_grad = fn(emb_j)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-2)
    _close("bfloat16", grad, want_grad)
    ref_loss, ref_grad = profile_unsup.block_fn("sddmm_xla", pairs)(emb)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-2)
    _close("bfloat16", grad, ref_grad)


@pytest.mark.parametrize("kind", ["sup", "unsup"])
def test_unsup_tool_epochs_equal_the_jax_tool(graphs, jax_unsup, small_unsup,
                                              kind):
    """The sup and unsup epochs (a refresh, then STEPS steps; unsup on the
    fixed pairs) against the JAX tool's scanned programs: losses."""
    jpad = graphs[1]
    program, args = jax_unsup[1][3 if kind == "sup" else 4]
    params, feats, _, _, batches, labels, key = args
    want = program(*args)
    mcfg = GraphSageConfig(num_layers=2, input_size=D, out_size=H,
                           compute_dtype="bfloat16")
    pairs = (None if kind == "sup" else profile_unsup.block_inputs(CPU)[0])
    hop = JaxHop(_jax_keys(key, REPS, True), jpad)
    losses = bench.cached_epoch(mcfg, pairs=pairs)(
        _leaf_params(jax.device_get(params), CPU), _tt(feats), hop,
        _t(batches), _t(labels))
    assert not hop.keys
    _check("bfloat16", losses, want)


# ------------------------------------------------------------ entry points

MODULES = [step_anatomy, profile_cached, profile_unsup]


@pytest.mark.parametrize("module", MODULES,
                         ids=lambda m: m.__name__.split(".")[-1])
def test_without_a_card_it_raises(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("module", MODULES,
                         ids=lambda m: m.__name__.split(".")[-1])
def test_main_writes_only_under_out(module, tmp_path, monkeypatch, capsys):
    """A CPU drive at small sizes: the record goes to --out, nothing to
    the working directory; step_anatomy's rows merge by (workload, batch,
    mode), fresh rows winning."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    small = {step_anatomy: {"REPS": REPS},
             profile_cached: {"B": B, "HIDDEN": H, "ITERS": REPS},
             profile_unsup: SMALL_UNSUP}[module]
    for name, value in small.items():
        monkeypatch.setattr(module, name, value)
    argv = ["--device", "cpu", "--out", str(out)]
    if module is step_anatomy:
        assert module.main(["tiny", "64", "128", *argv]) == 0
        assert module.main(["tiny", "64", *argv]) == 0
    else:
        assert module.main([*argv, "--nodes", "300", "--edges", "1500"]) == 0
    assert os.listdir(tmp_path) == ["out"]
    rec = json.loads((out / module.OUT_FILE).read_text())
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    if module is step_anatomy:
        with open(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "PROFILE_ANATOMY_r05.json")) as f:
            want = set(json.load(f)["rows"][0])
        assert [(r["workload"], r["batch"]) for r in rec["rows"]] == [
            ("tiny", 64), ("tiny", 128)]
        assert last == rec["rows"][:1]
        for row in rec["rows"]:
            assert set(row) == want | ROW_EXTRAS
            for s in step_anatomy.SLICES:
                assert np.isfinite(row[f"{s}_ms"])
    elif module is profile_cached:
        assert last == rec["rows"][-1]
    else:
        assert last == rec


def test_write_merged_by_a_key(tmp_path):
    def key(r):
        return r.get("workload"), r.get("batch"), r.get("mode")

    write_merged({"rows": [{"workload": "a", "batch": 1, "v": 1},
                           {"workload": "a", "batch": 2, "v": 2}]},
                 str(tmp_path), "x.json", key=key)
    path = write_merged({"rows": [{"workload": "a", "batch": 2, "v": 3}]},
                        str(tmp_path), "x.json", key=key)
    got = json.loads(open(path).read())["rows"]
    assert got == [{"workload": "a", "batch": 2, "v": 3},
                   {"workload": "a", "batch": 1, "v": 1}]
