"""The port's benchmark entry points (graphsage_torch.bench and
graphsage_torch.infer_bench) against the JAX system's (bench.py and
tools/infer_bench.py), on the CPU, at small sizes (300 nodes, 16
features, hidden 8, batch 64, 3 steps):

- the registries: the same rows, in the same order, with the same fields;
- the accounting: matmul FLOPs a step and edges a batch at every registry
  row's shapes, and the layer-1 rows the port's byte rule picks;
- the epochs: the program each row kind times, against the program
  bench.py times (captured from its row functions), with JAX's params
  copied over and its draws replayed (``JaxHop``): float32 losses rtol
  1e-4 and final params atol 1e-4 (tests/test_torch_cached.py's epoch
  bars); bfloat16 losses rtol 1e-2 (tests/test_torch_bf16.py's); the unsup
  row's pair tensors bit for bit;
- serving: a row's embeddings against JAX's ``full_graph_embeddings`` on
  the same params (float32 rtol 1e-4, atol 1e-5; bfloat16 within 2 bf16
  ulps of the row's largest magnitude, tests/test_torch_infer.py's bars);
- the orchestrators, with a tiny registry patched in.
"""

import ast
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu import infer as jax_infer
from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_torch import bench, infer_bench
from graphsage_torch.convert import params_to_numpy
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig, init_graphsage
from graphsage_torch.train import cached, dense
from graphsage_torch.train.trainer import _leaf_params
from tests.test_bench_registry import _load_bench
from tests.test_torch_cached import JaxHop, _assert_params_close, _t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, C, H, B, T = 300, 16, 4, 8, 64, 3
CPU = torch.device("cpu")
# (nodes, features, classes) of each registry dataset
SHAPES = {"powerlaw": (100_000, 602, 16), "pubmed": (19717, 500, 3),
          "cora": (2708, 1433, 7)}


@pytest.fixture(scope="module")
def jbench():
    return _load_bench()


@pytest.fixture(scope="module")
def graphs():
    """The same small graph from each package, and its width-32 table."""
    jds = jax_power_law(N, 5 * N, num_feats=D, num_classes=C, seed=4)
    ds = synthetic_power_law(N, 5 * N, num_feats=D, num_classes=C, seed=4)
    jpad = jds.graph.to_padded_sampled(32, np.random.RandomState(99))
    pad = ds.graph.to_padded_sampled(32, np.random.RandomState(99))
    np.testing.assert_array_equal(pad.neighbors, jpad.neighbors)
    return jds, jpad, ds, pad


# ------------------------------------------------------------ registries

def test_registry_equals_the_jax_suites(jbench):
    assert bench._row_specs() == jbench._row_specs()
    assert bench.HEADLINE_ROW == jbench.HEADLINE_ROW
    assert bench.TIMED_REPS == jbench.TIMED_REPS
    assert bench.REFERENCE_EDGES_PER_SEC == jbench.REFERENCE_EDGES_PER_SEC


def test_serving_registry_equals_the_jax_suites():
    """tools/infer_bench.py's run(name, ds, pad, dtype, agg) calls, its
    sampled widths and REPS, read from its source."""
    with open(os.path.join(ROOT, "tools", "infer_bench.py")) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    want = [(c.args[0].value, c.args[3].value, c.args[4].value)
            for c in calls
            if getattr(c.func, "id", None) == "run"]
    widths = [c.args[0].value for c in calls
              if getattr(c.func, "attr", None) == "to_padded_sampled"]
    reps = next(n.value.value for n in tree.body
                if isinstance(n, ast.Assign) and n.targets[0].id == "REPS")
    specs = infer_bench._row_specs(bigscale=True)
    assert [(s["name"], s["dtype"], s["agg"]) for s in specs] == want
    assert [s["width"] for s in specs if s["width"]] == [32, 32, 16]
    assert widths == [32, 16]
    assert [s["name"] for s in infer_bench._row_specs()] == [
        w[0] for w in want[:-1]]
    assert infer_bench.REPS == reps


# ------------------------------------------------------------ accounting

@pytest.mark.parametrize("spec", bench._row_specs(),
                         ids=lambda s: s["name"])
def test_accounting_equals_the_jax_suites(jbench, spec):
    n, d, c = SHAPES[spec["dataset"]]
    pipeline, batch = spec.get("pipeline", "cached"), spec["batch"]
    args = (pipeline, n, d, batch, 10, 128, c, spec.get("agg", "MEAN"))
    assert (bench.matmul_flops_per_step(*args)
            == jbench.matmul_flops_per_step(*args))
    assert (dense.edges_per_batch(batch, 2, 10)
            == jbench.edges_per_batch(batch, 2, 10))
    if pipeline == "cached":
        m1 = batch * 11
        full = cached.layer1_full_table(n, d, m1, 128)
        assert (n if full else m1) == min(m1, n)


# ------------------------------------------------------------ epochs

def _captured(module, monkeypatch, run):
    """(epoch, args) of the program ``run()`` times through
    ``module._timed``, which is patched to time nothing."""
    seen = []

    def capture(epoch, args, *rest):
        seen.append((epoch, args))
        if module is bench:
            return 1.0, [1.0], {}
        return 1.0, [1.0]

    monkeypatch.setattr(module, "_timed", capture)
    run()
    (got,) = seen
    return got


def _jax_keys(key, steps: int, cached_pipeline: bool) -> list:
    """The keys of JAX's hops in the order the port draws them: the
    refresh's (cached), then each scanned step's split(sub, hops)."""
    keys = []
    if cached_pipeline:
        k_cache, key = jax.random.split(key)
        keys.append(k_cache)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys += list(jax.random.split(sub, 1 if cached_pipeline else 2))
    return keys


@pytest.mark.parametrize("kind,pipeline,dtype,agg", [
    ("sup", "cached", "float32", "MEAN"),
    ("sup", "cached", "bfloat16", "MEAN"),
    ("sup", "cached", "bfloat16", "MAX"),
    ("sup", "cached", "bfloat16", "LSTM"),
    ("unsup", "cached", "bfloat16", "MEAN"),
    ("sup", "dense", "bfloat16", "MEAN"),
], ids=["cached_mean_f32", "cached_mean_bf16", "cached_max_bf16",
        "lstm_hybrid_bf16", "unsup_bf16", "dense_bf16"])
def test_epoch_equals_the_program_bench_py_times(jbench, graphs, monkeypatch,
                                                 kind, pipeline, dtype, agg):
    jds, jpad, ds, pad = graphs
    targets = 16
    if kind == "unsup":
        jrun = lambda: jbench.run_unsup_row("x", jds, jpad, B, dtype,
                                            hidden=H, steps=T,
                                            n_targets=targets)
        run = lambda: bench.run_unsup_row("x", ds, pad, B, dtype, hidden=H,
                                          steps=T, n_targets=targets,
                                          device="cpu")
    else:
        jrun = lambda: jbench.run_row("x", jds, jpad, pipeline, B, dtype,
                                      hidden=H, steps=T, agg=agg)
        run = lambda: bench.run_row("x", ds, pad, pipeline, B, dtype,
                                    hidden=H, steps=T, agg_func=agg,
                                    device="cpu")
    jepoch, jargs = _captured(jbench, monkeypatch, jrun)
    epoch, (_, feats, _, batches, labels) = _captured(bench, monkeypatch,
                                                      run)
    jparams, jfeats, _, _, jbatches, jlabels, key = jargs
    np.testing.assert_array_equal(batches.numpy(), np.asarray(jbatches))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(feats.float().numpy(),
                                  np.asarray(jfeats, np.float32))
    if kind == "unsup":
        want = inspect.getclosurevars(jepoch.__wrapped__).nonlocals["pairs"]
        got = inspect.getclosurevars(epoch).nonlocals["pairs"]
        assert set(got) == set(want)
        for field, value in want.items():
            assert got[field].dtype == _t(value).dtype, field
            np.testing.assert_array_equal(got[field].numpy(),
                                          np.asarray(value))

    want_params, want_losses = jepoch(*jargs)
    params = _leaf_params(jax.device_get(jparams), CPU)
    hop = JaxHop(_jax_keys(key, T, pipeline == "cached"), jpad)
    losses = epoch(params, feats, hop, batches, labels)
    assert not hop.keys and losses.shape == (T,)
    if dtype == "float32":
        np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                                   rtol=1e-4)
        _assert_params_close(params, want_params, atol=1e-4)
    else:
        np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                                   rtol=1e-2)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("agg,dtype", [("MEAN", "float32"),
                                       ("MAX", "bfloat16")])
def test_serving_row_equals_jax(graphs, agg, dtype):
    """The row's embeddings against JAX's full_graph_embeddings on the
    row's own params (a torch.Generator seeded 824)."""
    jds, jpad, ds, pad = graphs
    row, got = infer_bench.serve_row("x", ds, pad, dtype, agg, device="cpu")
    cfg = GraphSageConfig(num_layers=2, input_size=D, out_size=128,
                          agg_func=agg, compute_dtype=dtype)
    params = params_to_numpy(init_graphsage(
        torch.Generator().manual_seed(infer_bench.PARAM_SEED), cfg))
    jcfg = JaxConfig(num_layers=2, input_size=D, out_size=128, agg_func=agg,
                     compute_dtype=dtype)
    want = jax_infer.full_graph_embeddings(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, jds.features,
        jpad)
    assert got.shape == (N, 128) and row["nodes"] == N
    assert row["edge_slots"] == int(pad.degrees.sum())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got - want) <= 2 * 2.0**-8 * scale + 1e-30).all()


# ------------------------------------------------------------ orchestrators

ROW_KEYS = {"name", "pipeline", "dtype", "agg", "batch", "nodes",
            "edge_slots", "step_ms", "edges_per_sec",
            "matmul_tflops_per_sec", "mfu", "device", "vs_reference",
            "rep_step_ms", "power_limit", "peak_tflops", "launches"}


def _tiny(monkeypatch, module, graphs, specs):
    """``specs`` as the registry of ``module``, its "tiny" dataset the
    small graph, and no citation graph on disk."""
    _, _, ds, pad = graphs
    monkeypatch.setattr(bench, "_DATA_ROOT", os.path.join(ROOT, "build",
                                                          "no_such_data"))
    monkeypatch.setattr(module, "_row_specs", lambda *a: specs)
    if module is bench:
        monkeypatch.setattr(bench, "_load_dataset", lambda tag: (ds, pad))
    else:
        monkeypatch.setattr(infer_bench, "_load", lambda tag: ds)


def _raise_for(name, run):
    def run_or_raise(spec, *args, **kw):
        if spec["name"] == name:
            raise RuntimeError("injected fault")
        return run(spec, *args, **kw)
    return run_or_raise


@pytest.mark.parametrize("with_error", [False, True])
def test_suite_rows_skips_errors_and_summary(graphs, monkeypatch, capsys,
                                             tmp_path, with_error):
    """In process: a measured row with the listed keys, an absent dataset
    as a skipped row naming its file, a raising row as an error row and
    exit code 1; the summary line always; the files in the given
    directory (promoted only when nothing errored), none at the root."""
    head = {"name": bench.HEADLINE_ROW, "dataset": "tiny", "kind": "sup",
            "pipeline": "cached", "batch": B, "dtype": "bfloat16",
            "agg": "MEAN", "steps": T, "note": None}
    cora = bench._row_specs()[-1]
    specs = [head, cora] + ([dict(head, name="boom")] if with_error else [])
    _tiny(monkeypatch, bench, graphs, specs)
    monkeypatch.setattr(bench, "run_spec", _raise_for("boom",
                                                      bench.run_spec))
    monkeypatch.setenv("GS_BENCH_INPROC", "1")
    before = {f: os.path.getmtime(os.path.join(ROOT, f))
              for f in os.listdir(ROOT) if f.startswith("BENCH_DETAIL")}
    rc = bench.main(["--device", "cpu", "--out", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == int(with_error)
    assert summary["row"] == bench.HEADLINE_ROW
    assert (summary["rows_completed"], summary["rows_failed"],
            summary["rows_skipped"]) == (1, int(with_error), 1)
    assert summary["device"] == "cpu" and "power_limit" in summary
    promoted = tmp_path / "BENCH_DETAIL.json"
    partial = tmp_path / "BENCH_DETAIL.partial.json"
    assert promoted.exists() != with_error
    assert partial.exists() == with_error
    assert summary["detail_artifact"] == str(partial if with_error
                                             else promoted)
    rows = json.loads((partial if with_error else promoted).read_text())
    assert set(rows[0]) == ROW_KEYS
    assert rows[0]["device"] == "cpu" and rows[0]["step_ms"] > 0
    assert rows[1]["missing"].endswith(os.path.join("cora", "cora.cites"))
    assert rows[1]["missing"] in rows[1]["skipped"]
    if with_error:
        assert rows[2] == {"name": "boom",
                           "error": "RuntimeError: injected fault"}
    after = {f: os.path.getmtime(os.path.join(ROOT, f))
             for f in os.listdir(ROOT) if f.startswith("BENCH_DETAIL")}
    assert after == before
    assert bench.DEFAULT_OUT == os.path.join(ROOT, "build", "bench_torch")


def test_child_failure_is_an_error_row(graphs, monkeypatch, capsys,
                                       tmp_path):
    """A row run in a child process that exits non-zero (here: a row the
    child's registry lacks) is an error row with the child's last lines,
    run once; exit code 1 and the summary line with no completed row."""
    spec = dict(bench._row_specs()[0], name="no_such_row")
    _tiny(monkeypatch, bench, graphs, [spec])
    monkeypatch.delenv("GS_BENCH_INPROC", raising=False)
    rc = bench.main(["--device", "cpu", "--out", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert summary["value"] == 0 and summary["rows_failed"] == 1
    assert summary["error"] == "no bench row completed"
    (row,) = json.loads((tmp_path / "BENCH_DETAIL.partial.json").read_text())
    assert row["error"].startswith("rc=1") and "no_such_row" in row["error"]


def test_infer_suite_rows_skips_and_errors(graphs, monkeypatch, capsys,
                                           tmp_path):
    cora, row = infer_bench._row_specs()[0], infer_bench._row_specs()[3]
    row = dict(row, dataset="tiny")
    _tiny(monkeypatch, infer_bench, graphs,
          [cora, row, dict(row, name="boom", agg="NOPE")])
    rc = infer_bench.main(["--device", "cpu", "--out", str(tmp_path)])
    assert rc == 1
    out = json.loads((tmp_path / "INFER.json").read_text())
    skipped, served, failed = out["rows"]
    assert skipped["missing"].endswith(os.path.join("cora", "cora.cites"))
    assert set(served) == {
        "name", "dtype", "agg", "nodes", "table_width", "edge_slots",
        "embed_all_ms", "nodes_per_sec", "edge_slots_per_sec",
        "first_call_s", "one_time_upload_s", "result_pull_s", "device",
        "power_limit", "launches", "kernel_build"}
    assert served["name"] == "powerlaw100k_cap32_bf16_max"
    assert served["device"] == "cpu" and served["kernel_build"] is None
    assert set(failed) == {"name", "error"}
    assert out["reps"] == infer_bench.REPS
    assert f"wrote {tmp_path / 'INFER.json'}" in capsys.readouterr().out


@pytest.mark.parametrize("module", [bench, infer_bench],
                         ids=["bench", "infer_bench"])
def test_without_a_card_it_raises(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
