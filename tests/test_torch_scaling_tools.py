"""The port's scaling tools (graphsage_torch.halo_overhead, .scaling_bench,
.pairs_scale_bench) against the JAX system's tools/halo_overhead.py,
tools/scaling_bench.py and tools/pairs_scale_bench.py, on the CPU, at
tests/test_torch_distributed.py's small sizes (600 nodes, 3000 edges, 24
features, hidden 16, b_loc 6; halo_overhead's hidden stays 128 and its
virtual b_loc 512, fixed in both tools) and P in {1, 2}:

- the record keys and row names of the JAX tools (theirs captured by
  calling ``run_chip`` / ``run_virtual`` with ``synthetic_power_law`` and
  ``_chain_timed`` patched, ``scaling_bench.main()`` with ``--cpu --out
  tmp_path/...`` and its programs recorded but not compiled, and
  ``pairs_scale_bench.main()`` from a copy under ``tmp_path/tools/``, so
  that no file of the repository is written), and the rows' formulas on
  the same times;
- the host batches bit for bit: both halo tools' ``DistBatch``es, the
  epoch stacks of every world (one ``RandomState(0)`` across the worlds),
  the pair batches and far lists;
- the timed programs against the JAX programs from the same params
  (copied with ``convert.py``): the dist step and the oracle step of
  ``halo_overhead chip`` (float32: loss rtol 1e-5, params atol 1e-6;
  bfloat16: ``assert_step_close``), ``scaling_bench``'s halo run at P = 1
  (its warm and timed steps, the same bars) and its cached epoch at P = 1
  against ``make_cached_dist_epoch`` with JAX's draws replayed
  (``ReplayHop``; the epoch's 2 steps: losses rtol 1e-5, params atol 1e-5,
  tests/test_torch_cached_dist.py's epoch bars);
- the modules' own rank launch (``parallel/ranks.py``) at P = 2, gloo:
  ``run_virtual`` and ``scaling_bench.main`` write rows with the JAX keys;
- ``main`` writes only under ``--out`` (merging halo rows by (mode,
  n_dev)).
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphsage_tpu.data as jax_data
import graphsage_tpu.train.cached_dist as jcd
import graphsage_tpu.train.distributed as jd
from graphsage_torch import halo_overhead, pairs_scale_bench, scaling_bench
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.parallel import multihost
from graphsage_torch.train.cached_dist import CachedDistStep, local_rows
from graphsage_torch.train.distributed import (dist_batch_to_device,
                                               make_dist_sup_step)
from graphsage_torch.train.trainer import _leaf_params
from tests.test_torch_bf16 import assert_step_close
from tests.test_torch_cached_dist import _jax_draws
from tests.test_torch_distributed import _assert_batches_equal
from tests.torch_dist_worker import ReplayHop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, D, H, B_LOC, STEPS = 600, 3000, 24, 16, 6, 2
LOSS_RTOL, PARAM_ATOL, EPOCH_ATOL = 1e-5, 1e-6, 1e-5
CPU = torch.device("cpu")
# the port's keys beyond the JAX tools'
ROW_EXTRAS = {"launches", "power_limit"}
RECORD_EXTRAS = {"device", "power_limit"}
# chain times the patched timers give, in the order the tools time
CHIP_MS = (8.0, 5.0)
VIRTUAL_MS = {1: 10.0, 2: 12.5, 4: 15.0, 8: 21.0}


def _load_tool(name: str, path: str | None = None):
    path = path or os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.detach().float() if isinstance(
            x, torch.Tensor) else jnp.asarray(x, jnp.float32)), tree)


def _assert_params_close(got, want, atol):
    for g, w in zip(jax.tree_util.tree_leaves(_np(got)),
                    jax.tree_util.tree_leaves(_np(want))):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def graphs():
    return (synthetic_power_law(N, E, num_feats=D, num_classes=16, seed=0),
            jax_data.synthetic_power_law(N, E, num_feats=D, num_classes=16,
                                         seed=0))


@pytest.fixture()
def world1():
    """A world-1 gloo group for the in-process port programs."""
    multihost.initialize("cpu")
    yield
    multihost.shutdown()


class _Recorder:
    """``jd.build_dist_batch`` recorded, and a ``_chain_timed`` stand-in
    that keeps (args_fn, step_fn) and returns the next of ``times``."""

    def __init__(self, monkeypatch, times):
        self.batches, self.programs, self.times = [], [], list(times)
        real = jd.build_dist_batch

        def build(*args, **kw):
            self.batches.append(real(*args, **kw))
            return self.batches[-1]

        monkeypatch.setattr(jd, "build_dist_batch", build)

    def chain_timed(self, args_fn, step_fn, reps=None):
        self.programs.append((args_fn, step_fn))
        return self.times.pop(0)


def _jax_chip(monkeypatch, jds, dtype):
    tool = _load_tool("halo_overhead")
    rec = _Recorder(monkeypatch, CHIP_MS)
    monkeypatch.setattr(jax_data, "synthetic_power_law",
                        lambda *a, **k: jds)
    monkeypatch.setattr(tool, "_chain_timed", rec.chain_timed)
    rows = tool.run_chip(b_loc=B_LOC, dtype=dtype)
    return rows, rec


# ------------------------------------------------------------ halo_overhead

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_chip_row_batch_and_programs(dtype, graphs, monkeypatch,
                                          world1):
    ds, jds = graphs
    (jrow,), rec = _jax_chip(monkeypatch, jds, dtype)
    db = halo_overhead.chip_batch(ds, B_LOC)
    _assert_batches_equal(db, rec.batches[0])

    # the row: the JAX keys plus the extras, the formulas on equal times
    times = iter([(ms, {}) for ms in CHIP_MS])
    monkeypatch.setattr(halo_overhead, "chain_timed",
                        lambda *a, **k: next(times))
    jparams, _ = rec.programs[0][0]()
    params = _np(jax.device_get(jparams))
    first = {}
    (row,) = halo_overhead.run_chip(ds, CPU, B_LOC, dtype, params, first)
    assert set(row) == set(jrow) | ROW_EXTRAS
    for k in jrow:
        if k not in ("device", "note"):
            assert row[k] == jrow[k], k
    assert row["device"] == "cpu" and "gloo" in row["note"]
    np.testing.assert_allclose(first["local_oracle"], first["dist_step"],
                               rtol=LOSS_RTOL if dtype == "float32"
                               else 1e-2)

    # both programs against JAX's, one step from the same params
    mcfg = GraphSageConfig(num_layers=2, input_size=D, out_size=128,
                           compute_dtype=dtype)
    feats = torch.from_numpy(ds.features).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    t = dist_batch_to_device(db, CPU)
    x0 = torch.from_numpy(db.x0_ids[0])
    ports = {"dist": lambda p: make_dist_sup_step(mcfg)(p, feats, t),
             "local": lambda p: halo_overhead.make_local_step(mcfg)(
                 p, feats, x0, t["frontiers"], t["labels"],
                 t["row_mask"])}
    for (args_fn, step_fn), name in zip(rec.programs, ("dist", "local")):
        p, args = args_fn()
        want_params, want_loss = step_fn(p, *args)
        port_params = _leaf_params(params, CPU)
        loss = ports[name](port_params)
        if dtype == "float32":
            np.testing.assert_allclose(float(loss), float(want_loss),
                                       rtol=LOSS_RTOL)
            _assert_params_close(port_params, want_params, PARAM_ATOL)
        else:
            assert_step_close(f"halo_overhead {name}", loss, want_loss,
                              params, _np(port_params),
                              _np(jax.device_get(want_params)))


def test_halo_virtual_rows_and_batches(graphs, monkeypatch):
    ds, jds = graphs
    tool = _load_tool("halo_overhead")
    rec = _Recorder(monkeypatch, [VIRTUAL_MS[p] for p in (1, 2, 4, 8)])
    monkeypatch.setattr(jax_data, "synthetic_power_law",
                        lambda *a, **k: jds)
    monkeypatch.setattr(tool, "_chain_timed", rec.chain_timed)
    jrows = tool.run_virtual()

    payloads = list(halo_overhead.virtual_payloads(ds))
    assert [p for p, _ in payloads] == [1, 2, 4, 8]
    for (world, payload), jdb in zip(payloads, rec.batches):
        _assert_batches_equal(payload["batch"], jdb)
        assert payload["feats"].shape[0] % world == 0

    def ranks(fn, payload, world, **kw):
        assert fn == "graphsage_torch.halo_overhead:virtual_rank"
        return [{"ms": VIRTUAL_MS[world], "launches": {}}]

    monkeypatch.setattr(halo_overhead, "run_ranks", ranks)
    rows = halo_overhead.run_virtual(ds, log=lambda *a: None)
    assert [r["mode"] for r in rows] == [r["mode"] for r in jrows]
    for row, jrow in zip(rows, jrows):
        if jrow["mode"] == "virtual_weak_scaling_note":
            assert set(row) == set(jrow)
            continue
        assert set(row) == set(jrow) | {"launches"}
        assert {k: row[k] for k in jrow} == jrow


def test_halo_virtual_launches_two_gloo_ranks(graphs):
    """The module's own launch: two rank processes, one row with the JAX
    keys (and the note)."""
    ds, _ = graphs
    rows = halo_overhead.run_virtual(ds, worlds=(2,), b_loc=B_LOC,
                                     hidden=H, log=lambda *a: None)
    assert [r["mode"] for r in rows] == ["virtual_weak_scaling",
                                         "virtual_weak_scaling_note"]
    row = rows[0]
    assert set(row) == {"mode", "n_dev", "b_loc", "step_ms",
                        "edges_per_sec", "efficiency_vs_1dev", "host_cpus",
                        "launches"}
    assert row["n_dev"] == 2 and row["step_ms"] > 0
    assert row["efficiency_vs_1dev"] == round(1 / 2, 3)


def test_halo_main_writes_only_under_out(tmp_path, monkeypatch):
    rows = {"chip": [{"mode": "chip_mesh1_overhead", "v": 1}],
            "virtual": [{"mode": "virtual_weak_scaling", "n_dev": 1},
                        {"mode": "virtual_weak_scaling_note", "note": ""}]}
    monkeypatch.setattr(halo_overhead, "run_chip",
                        lambda ds, dev: rows["chip"])
    monkeypatch.setattr(halo_overhead, "run_virtual",
                        lambda ds, log: rows["virtual"])
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    assert halo_overhead.main(["virtual", "--out", str(out)]) == 0
    assert halo_overhead.main(["chip", "--device", "cpu", "--out",
                               str(out)]) == 0
    rows["chip"] = [{"mode": "chip_mesh1_overhead", "v": 2}]
    assert halo_overhead.main(["chip", "--device", "cpu", "--out",
                               str(out)]) == 0
    assert sorted(os.listdir(tmp_path)) == ["out"]
    assert os.listdir(out) == [halo_overhead.OUT_FILE]
    with open(out / halo_overhead.OUT_FILE) as f:
        merged = json.load(f)["rows"]
    assert merged == rows["chip"] + rows["virtual"]


# ------------------------------------------------------------ scaling_bench

def _jax_scaling(tmp_path, monkeypatch, pipeline):
    """JAX's main at the small size over worlds 1 and 2: its programs
    recorded (the real ones kept, stand-ins run), its batches and stacks
    recorded."""
    tool = _load_tool("scaling_bench")
    rec = {"batches": [], "stacks": [], "programs": [], "calls": []}
    real_build, real_stack = jd.build_dist_batch, jcd.build_epoch_stack
    real_step, real_epoch = jd.make_dist_sup_step, jcd.make_cached_dist_epoch

    def build(*args, **kw):
        rec["batches"].append(real_build(*args, **kw))
        return rec["batches"][-1]

    def stack(*args, **kw):
        rec["stacks"].append(real_stack(*args, **kw))
        return rec["stacks"][-1]

    def fake(real):
        def make(*args, **kw):
            rec["programs"].append((args[1].size, real(*args, **kw)))
            calls = []
            rec["calls"].append(calls)

            def program(params, *a):
                calls.append((params, a))
                return params, jnp.zeros((1,))

            return program
        return make

    monkeypatch.setattr(jd, "build_dist_batch", build)
    monkeypatch.setattr(jcd, "build_epoch_stack", stack)
    monkeypatch.setattr(jd, "make_dist_sup_step", fake(real_step))
    monkeypatch.setattr(jcd, "make_cached_dist_epoch", fake(real_epoch))
    out = tmp_path / f"jax_{pipeline}.json"
    monkeypatch.setattr("sys.argv", [
        "scaling_bench.py", "--nodes", str(N), "--edges", str(E),
        "--feat_dim", str(D), "--hidden", str(H), "--b_loc", str(B_LOC),
        "--steps", str(STEPS), "--devices", "1,2", "--pipeline", pipeline,
        "--cpu", "--out", str(out)])
    tool.main()
    with open(out) as f:
        return json.load(f), rec


def _record_keys(record, jrecord):
    assert set(record) == set(jrecord) | RECORD_EXTRAS
    assert set(record["workload"]) == set(jrecord["workload"])
    assert record["workload"] == jrecord["workload"]
    assert [set(r) - {"launches"} for r in record["results"]] == [
        set(r) for r in jrecord["results"]]
    assert [r["devices"] for r in record["results"]] == [1, 2]


def _payloads(pipeline, ds):
    rng = np.random.RandomState(0)
    if pipeline == "halo":
        return list(scaling_bench.halo_payloads(ds, [1, 2], B_LOC, 10,
                                                STEPS, rng))
    return list(scaling_bench.cached_payloads(ds, [1, 2], B_LOC, STEPS,
                                              rng))


def test_scaling_halo_batches_keys_and_program(graphs, tmp_path,
                                               monkeypatch, world1):
    ds, _ = graphs
    jrecord, rec = _jax_scaling(tmp_path, monkeypatch, "halo")
    payloads = _payloads("halo", ds)
    # both worlds' batches from the one stream, in the JAX tool's order
    mine = [db for _, p in payloads for db in p["warm"] + p["timed"]]
    assert len(mine) == len(rec["batches"]) == 2 * (2 + STEPS)
    for db, jdb in zip(mine, rec["batches"]):
        _assert_batches_equal(db, jdb)
    for world, p in payloads:
        np.testing.assert_array_equal(
            p["feats"], jax.device_get(rec["calls"][world - 1][0][1][0]))

    # world 1: the port's run (warm and timed steps) against JAX's step
    (size, jstep), calls = rec["programs"][0], rec["calls"][0]
    assert size == 1 and len(calls) == 2 + STEPS
    jparams = jax.device_get(calls[0][0])
    p = calls[0][0]
    for _, args in calls:
        p, jloss = jstep(p, *args)
    payload = dict(payloads[0][1], params=_np(jparams), cfg={
        "num_layers": 2, "input_size": D, "out_size": H})
    res = scaling_bench.halo_world(payload, 0, 1, CPU)
    np.testing.assert_allclose(res["loss"], float(jloss), rtol=LOSS_RTOL)
    _assert_params_close(res["params"], jax.device_get(p), PARAM_ATOL)

    # the record: through the port's main on gloo ranks (P = 1, 2)
    out = tmp_path / "port"
    assert scaling_bench.main([
        "--device", "cpu", "--nodes", str(N), "--edges", str(E),
        "--feat_dim", str(D), "--hidden", str(H), "--b_loc", str(B_LOC),
        "--steps", str(STEPS), "--devices", "1,2", "--out", str(out)]) == 0
    assert os.listdir(out) == ["SCALING_halo.json"]
    with open(out / "SCALING_halo.json") as f:
        record = json.load(f)
    _record_keys(record, jrecord)
    assert record["backend"] == "cpu" and record["pipeline"] == "halo"


def test_scaling_cached_stacks_keys_and_epoch(graphs, tmp_path,
                                              monkeypatch, world1):
    ds, _ = graphs
    jrecord, rec = _jax_scaling(tmp_path, monkeypatch, "cached")
    payloads = _payloads("cached", ds)
    assert len(rec["stacks"]) == 2
    for (world, p), jstack in zip(payloads, rec["stacks"]):
        t_steps = min(STEPS, jstack[0].shape[0])
        for a, b in zip(p["stack"], jstack):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b[:t_steps])
        for a, b in zip((p["feats"], p["neighbors"], p["degrees"]),
                        rec["calls"][world - 1][0][1][:3]):
            np.testing.assert_array_equal(a, jax.device_get(b))

    # world 1: one epoch from JAX's params, JAX's draws replayed
    (size, jepoch), calls = rec["programs"][0], rec["calls"][0]
    assert size == 1 and len(calls) == 4
    jparams, args = calls[0][0], calls[0][1]
    key = jax.random.PRNGKey(0)
    assert np.array_equal(jax.device_get(args[-1]), key)
    want_params, want_losses = jepoch(jparams, *args[:-1], key)
    p = payloads[0][1]
    tables = (p["feats"], p["neighbors"], p["degrees"])
    draws = _jax_draws(key, tables, p["stack"][0], 1, 10)[0]
    mcfg = GraphSageConfig(num_layers=2, input_size=D, out_size=H)
    params = _leaf_params(_np(jax.device_get(jparams)), CPU)
    feats = torch.from_numpy(p["feats"])
    hop = ReplayHop(draws)
    losses = scaling_bench.cached_epoch(
        CachedDistStep(mcfg, fanout=10, lr=scaling_bench.LR), params,
        feats, local_rows(feats, 0, 1), hop,
        [torch.from_numpy(a[:, 0]) for a in p["stack"]], 10, 0, 1)
    assert not hop.draws
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=LOSS_RTOL)
    _assert_params_close(params, jax.device_get(want_params), EPOCH_ATOL)

    # the record: through the port's main on gloo ranks (P = 1, 2)
    out = tmp_path / "port"
    assert scaling_bench.main([
        "--device", "cpu", "--nodes", str(N), "--edges", str(E),
        "--feat_dim", str(D), "--hidden", str(H), "--b_loc", str(B_LOC),
        "--steps", str(STEPS), "--devices", "1,2", "--pipeline", "cached",
        "--out", str(out)]) == 0
    with open(out / "SCALING_cached.json") as f:
        record = json.load(f)
    _record_keys(record, jrecord)


def test_scaling_on_eight_cards_runs_world_one_and_logs_the_rest(
        graphs, monkeypatch):
    """On a host with 8 cards the default worlds 1, 2, 4, 8 give world 1's
    result and one line naming the worlds skipped (a larger world would
    need one process a card)."""
    ds, _ = graphs
    ran = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(scaling_bench, "run_world", lambda payload, n, dev: (
        ran.append(n) or {"dt": 0.01, "launches": {}}))
    monkeypatch.setattr(scaling_bench.bench, "card",
                        lambda dev: ("card", "700.00 W"))
    lines = []
    record = scaling_bench.run(ds, torch.device("cuda"), "halo", hidden=H,
                               b_loc=B_LOC, steps=STEPS, log=lines.append)
    assert ran == [1]
    assert [r["devices"] for r in record["results"]] == [1]
    skipped = [line for line in lines if "skipped" in line]
    assert len(skipped) == 1 and "[2, 4, 8]" in skipped[0]


# ----------------------------------------------------------- pairs_scale_bench

def _recording(sampler_cls, far_fn, seen: list):
    """A ``PairSampler`` subclass and a ``far_lists_native`` whose results
    land in ``seen``."""
    class Sampler(sampler_cls):
        def sample_batch(self, *args, **kw):
            pb = super().sample_batch(*args, **kw)
            seen.append(("batch", self.negative_mode, pb))
            return pb

    def far(*args, **kw):
        out = far_fn(*args, **kw)
        seen.append(("far", None, out))
        return out

    return Sampler, far


def test_pairs_scale_keys_batches_and_far_lists(tmp_path, monkeypatch):
    monkeypatch.delenv("GS_EXACT_NEG_BUDGET_S", raising=False)
    n, e = 2400, 12000     # 1,200 train nodes: the tool draws 1,024 roots
    os.makedirs(tmp_path / "tools")
    shutil.copy(os.path.join(ROOT, "tools", "pairs_scale_bench.py"),
                tmp_path / "tools")
    tool = _load_tool("pairs_scale_bench",
                      str(tmp_path / "tools" / "pairs_scale_bench.py"))
    jds = jax_data.synthetic_power_law(n, e, num_feats=8, num_classes=16,
                                       seed=0)
    jseen, seen = [], []
    sampler, far = _recording(tool.PairSampler, tool.far_lists_native,
                                   jseen)
    monkeypatch.setattr(tool, "synthetic_power_law", lambda *a, **k: jds)
    monkeypatch.setattr(tool, "PairSampler", sampler)
    monkeypatch.setattr(tool, "far_lists_native", far)
    tool.main()
    with open(tmp_path / "PAIRS_SCALE_r04.json") as f:
        jout = json.load(f)

    sampler, far = _recording(pairs_scale_bench.PairSampler,
                                   pairs_scale_bench.far_lists_native, seen)
    monkeypatch.setattr(pairs_scale_bench, "PairSampler", sampler)
    monkeypatch.setattr(pairs_scale_bench, "far_lists_native", far)
    out = tmp_path / "out"
    monkeypatch.chdir(tmp_path)
    assert pairs_scale_bench.main(["--nodes", str(n), "--edges", str(e),
                                   "--out", str(out)]) == 0
    assert os.listdir(out) == [pairs_scale_bench.OUT_FILE]
    with open(out / pairs_scale_bench.OUT_FILE) as f:
        record = json.load(f)

    assert list(record) == list(jout)
    assert record["auto_rule"].keys() == jout["auto_rule"].keys()
    assert record["far_list_sizes"] == jout["far_list_sizes"]
    assert record["auto_rule"]["decision_here"] == "exact"
    for k in ("host_cores", "num_neg", "first_epoch_steps", "far_cache_mb"):
        assert record[k] == jout[k], k
    assert record["auto_rule"]["rule"] == jout["auto_rule"]["rule"]
    assert len(seen) == len(jseen) > 2
    for (kind, mode, got), (jkind, jmode, want) in zip(seen, jseen):
        assert (kind, mode) == (jkind, jmode)
        if kind == "far":
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            continue
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f.name)),
                np.asarray(getattr(want, f.name)), err_msg=f.name)
