"""The port's quality and ablation tools (graphsage_torch.validate_cached,
.staleness_quality, .max_seed_study, .prefetch_bench, .profile_dense)
against the JAX system's tools of those names, on the CPU, on a 2,000-node
power-law stand-in (16 features) for Cora and Pubmed.

- The programs, from the same params (the JAX tools' own, copied with
  ``convert.py``) with JAX's draws replayed (``JaxHop``): validate_cached's
  epochs against the tool's ``make_cached_sup_epoch`` (2 epochs, hidden 8,
  b_sz 256, cap 16), in float32 (losses rtol 1e-4, final params atol 1e-4)
  and bfloat16 (losses rtol 1e-2, the update within 2e-2 of its largest
  element), its batch stacks bit for bit, its printed lines and F1s;
  profile_dense's three programs against the tool's jitted scans (2 x 16
  steps, cap 8; the tool's hidden 128): losses rtol 1e-4, params atol
  1e-4, forward sums rtol 1e-4, sampling sums exact.
- The studies (staleness_quality, max_seed_study, prefetch_bench) against
  their tools with the trainers replaced by one recorder in both: the
  configs each tool builds, the record keys and protocol strings, and the
  rows and summary on the same F1s; each port module once more with its
  real trainer at 2 epochs.
- prefetch_bench's depths 0 and 2 end with bit-equal params.
- Each ``main`` raises without its dataset (``FileNotFoundError``) and
  without a card, and writes nothing outside ``--out``.

The JAX tools that write files run where nothing of the repository is
written: ``max_seed_study`` from a copy under ``tmp_path/tools/``,
``staleness_quality`` in ``tmp_path``, ``prefetch_bench`` with ``--out``
in ``tmp_path``.
"""

import dataclasses
import functools
import json
import os
import re
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

import graphsage_tpu.data as jax_data
import graphsage_tpu.train as jax_train
from graphsage_torch import (max_seed_study, prefetch_bench, profile_dense,
                             staleness_quality, validate_cached)
from graphsage_torch.data import load_cora, load_dataset, load_pubmed
from graphsage_torch.data import synthetic_power_law
from tests.test_torch_cached import JaxHop
from tests.test_torch_scaling_tools import _assert_params_close, _load_tool, _np

N, E, D = 2000, 10000, 16
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
BF16_LOSS_RTOL, BF16_UPDATE_RTOL = 1e-2, 2e-2
# the port's record keys beyond the JAX tools'
EXTRAS = {"staleness_quality": {"power_limit"},
          "max_seed_study": {"device", "power_limit"},
          "prefetch_bench": {"device", "power_limit"}}


@pytest.fixture(scope="module")
def graphs():
    """The stand-in in both packages (the same arrays), 40% of its labels
    redrawn at random so that F1 stays below 1 and depends on the draws."""
    ds = synthetic_power_law(N, E, num_feats=D, num_classes=4, seed=824)
    jds = jax_data.synthetic_power_law(N, E, num_feats=D, num_classes=4,
                                       seed=824)
    rng = np.random.RandomState(5)
    labels = ds.labels.copy()
    noisy = rng.rand(N) < 0.4
    labels[noisy] = rng.randint(0, 4, int(noisy.sum()))
    return (dataclasses.replace(ds, labels=labels),
            dataclasses.replace(jds, labels=labels))


@pytest.fixture()
def jit_calls(monkeypatch):
    """``jax.jit`` recording each call of the jitted functions whose
    qualified name is listed in the returned dict: (args, output)."""
    real = jax.jit
    calls = {}

    def jit(fn, *a, **kw):
        jitted = real(fn, *a, **kw)
        name = getattr(fn, "__qualname__", "")
        if name not in calls:
            return jitted

        def call(*args):
            out = jitted(*args)
            calls[name].append((args, jax.device_get(out)))
            return out
        return call

    monkeypatch.setattr(jax, "jit", jit)
    return calls


def _shape(line: str) -> str:
    """A printed line with its numbers blanked."""
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def _hops_after(key, steps: int, hops: int) -> list:
    """The hop keys of a scan over ``steps`` steps from ``key``: per step
    k, sub = split(k), then split(sub, hops)."""
    keys, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        keys.extend(jax.random.split(sub, hops))
    return keys


# ------------------------------------------------------------ validate_cached

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_validate_cached_against_the_tool(dtype, graphs, monkeypatch, capsys,
                                          jit_calls):
    """The tool's main and the port's run on the stand-in, 2 epochs at
    b_sz 256, hidden 8, cap 16: the batch stacks bit for bit, the step
    losses and final params at the dtype's bars, the printed lines (their
    shape, and the same F1s)."""
    ds, jds = graphs
    argv = ["--dataSet", "standin", "--epochs", "2", "--b_sz", "256",
            "--hidden", "8", "--compute_dtype", dtype, "--cap", "16"]
    loads = []

    def load(name, seed):
        loads.append((name, seed))
        return jds

    epoch_name = "make_cached_sup_epoch.<locals>.epoch"
    jit_calls[epoch_name] = []
    monkeypatch.setattr(jax_data, "load_dataset", load)
    monkeypatch.setattr(sys, "argv", ["validate_cached.py"] + argv)
    capsys.readouterr()
    _load_tool("validate_cached").main()
    tool_lines = capsys.readouterr().out.strip().splitlines()
    assert loads == [("standin", 824)]
    epochs = jit_calls[epoch_name]
    assert len(epochs) == 2
    init = epochs[0][0][0]
    tables = types.SimpleNamespace(neighbors=np.asarray(epochs[0][0][2]),
                                   degrees=np.asarray(epochs[0][0][3]))
    steps = epochs[0][0][4].shape[0]

    def hop_for(seed, kind):
        key = jax.random.PRNGKey(seed)
        if kind == "epoch":      # make_cached_sup_epoch's key tree
            k_cache, k = jax.random.split(key)
            return JaxHop([k_cache] + _hops_after(k, steps, 1), tables)
        # the tool's embed: the refresh, then the forward's one hop
        return JaxHop([key] + list(jax.random.split(key, 1)), tables)

    batches, losses, lines = [], [], []
    real_batches, real_epoch = (validate_cached.epoch_batches,
                                validate_cached.cached_epoch_reuse)

    def record_batches(*args):
        batches.append(real_batches(*args))
        return batches[-1]

    def record_losses(*args):
        losses.append(real_epoch(*args))
        return losses[-1]

    monkeypatch.setattr(validate_cached, "epoch_batches", record_batches)
    monkeypatch.setattr(validate_cached, "cached_epoch_reuse", record_losses)
    rec = validate_cached.run(ds, epochs=2, b_sz=256, hidden=8,
                              compute_dtype=dtype, cap=16, device="cpu",
                              params=init, hop_for=hop_for,
                              log=lines.append)

    for got, (args, _) in zip(batches, epochs):
        np.testing.assert_array_equal(got, np.asarray(args[4]))
    want_losses = np.concatenate([np.asarray(out[1]) for _, out in epochs])
    got_losses = torch.cat(losses).float().numpy()
    want_params = epochs[-1][1][0]
    if dtype == "float32":
        np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
        _assert_params_close(rec["params"], want_params, PARAM_ATOL)
    else:
        np.testing.assert_allclose(got_losses, want_losses,
                                   rtol=BF16_LOSS_RTOL)
        leaves = zip(*(jax.tree_util.tree_leaves(_np(t)) for t in (
            init, rec["params"], want_params)))
        for before, got, want in leaves:
            scale = np.abs(want - before).max()
            assert np.abs(got - want).max() <= BF16_UPDATE_RTOL * scale
    assert len(lines) == len(tool_lines) == 3
    for got, want in zip(lines, tool_lines):
        assert _shape(got) == _shape(want), (got, want)
    for got, want in zip(lines[:-1], tool_lines[:-1]):
        assert _numbers(got)[1:] == _numbers(want)[1:], (got, want)
    assert [rec["best_val_f1"], rec["test_f1_at_best_val"]] == pytest.approx(
        _numbers(tool_lines[-1])[:2], abs=5e-5)


# ------------------------------------------------------------ the studies

class RecordingTrainer:
    """A trainer that records what it was built with and fits at once: its
    best val F1 a function of the seed and refresh_every, its history one
    improving entry (with test F1) and one that is not."""

    built = []

    def __init__(self, ds, mcfg, tcfg, *args, **kw):
        kw.pop("device", None)
        RecordingTrainer.built.append((ds, mcfg, tcfg, args, kw))
        self.tcfg = tcfg
        self.params = {"w": torch.zeros(1)}
        self.epochs_trained = 0

    def fit(self):
        val = 0.5 + (self.tcfg.seed % 17) / 100 + self.tcfg.refresh_every / 1000
        self.max_vali_f1 = val
        self.history = [{"epoch": 0, "val_f1": val, "test_f1": val - 0.03},
                        {"epoch": 1, "val_f1": val - 0.01}]
        return val

    def train_epoch(self):
        self.epochs_trained += 1
        return 1.0


@pytest.fixture()
def recorder():
    RecordingTrainer.built = []
    return RecordingTrainer


def _model_fields(mcfg) -> dict:
    """The model config's fields as the JAX package's config has them: the
    port's also holds ``pool_size``, GraphSAGE-pool's width, which no study
    sets (it keeps its default)."""
    fields = dataclasses.asdict(mcfg)
    if "pool_size" in fields:
        assert fields.pop("pool_size") == 512
    return fields


def _configs(built):
    """(mcfg fields, tcfg fields, positional args, keywords) of each built
    trainer."""
    return [(_model_fields(m), dataclasses.asdict(t), a, kw)
            for _, m, t, a, kw in built]


def _keys_match(got: dict, want: dict, extras: set) -> None:
    assert set(got) == set(want) | extras, (set(got), set(want))


def test_staleness_quality_against_the_tool(graphs, monkeypatch, tmp_path,
                                            capsys, recorder):
    """The tool's main (in tmp_path, its loaders and CachedTrainer
    replaced) and the port's main (the same): the trainers' configs, the
    record's keys and protocol, every row."""
    ds, jds = graphs
    small = synthetic_power_law(600, 3000, num_feats=D, num_classes=3,
                                seed=824)
    jsmall = jax_data.synthetic_power_law(600, 3000, num_feats=D,
                                          num_classes=3, seed=824)
    tool = _load_tool("staleness_quality")
    monkeypatch.setattr(tool, "load_cora", lambda: jds)
    monkeypatch.setattr(tool, "load_pubmed", lambda: jsmall)
    monkeypatch.setattr(tool, "CachedTrainer", recorder)
    monkeypatch.chdir(tmp_path)
    tool.main()
    with open(tmp_path / "STALENESS_r05.json") as f:
        want = json.load(f)
    want_built = _configs(recorder.built)
    assert [b[0] for b in recorder.built] == [jds] * 4 + [jsmall] * 4

    recorder.built = []
    out = tmp_path / "out"
    monkeypatch.setattr(staleness_quality, "load_cora", lambda: ds)
    monkeypatch.setattr(staleness_quality, "load_pubmed", lambda: small)
    monkeypatch.setattr(staleness_quality, "CachedTrainer", recorder)
    staleness_quality.main(["--device", "cpu", "--out", str(out)])
    with open(out / staleness_quality.OUT_FILE) as f:
        got = json.load(f)
    assert _configs(recorder.built) == want_built
    assert [b[0] for b in recorder.built] == [ds] * 4 + [small] * 4
    _keys_match(got, want, EXTRAS["staleness_quality"])
    assert got["protocol"] == want["protocol"]
    assert got["backend"] == "cpu"
    for name in ("cora", "pubmed"):
        assert got[name] == want[name]


def test_staleness_quality_trains(graphs):
    """The port's row with its real CachedTrainer, 2 epochs at k 2: the
    trainer refreshed on epoch 0 only and the row's F1s are its."""
    ds, _ = graphs
    trainers = []
    row = staleness_quality.run(ds, 256, 2, epochs=2, device="cpu",
                                trainers=trainers)
    (tr,) = trainers
    assert tr.tcfg.refresh_every == 2 and len(tr.history) == 2
    assert row["refresh_every"] == 2
    assert row["best_val_f1"] == round(tr.max_vali_f1, 4)
    assert 0.0 < row["best_val_f1"] <= 1.0
    assert 0.0 < row["test_f1_at_best_val"] <= 1.0


def test_max_seed_study_against_the_tool(graphs, monkeypatch, tmp_path,
                                         recorder):
    """The tool's main from a copy under tmp_path/tools (it writes beside
    its own file) and the port's main, their loaders and Trainer replaced:
    the seeds' loads and configs, the record's keys and strings, every
    seed's row and the summary arithmetic on the same F1s."""
    ds, jds = graphs
    os.makedirs(tmp_path / "tools")
    path = tmp_path / "tools" / "max_seed_study.py"
    shutil.copy(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "max_seed_study.py"), path)
    seeds = []
    monkeypatch.setattr(jax_data, "load_cora",
                        lambda seed: seeds.append(seed) or jds)
    monkeypatch.setattr(jax_train, "Trainer", recorder)
    monkeypatch.setattr(sys, "path", list(sys.path))
    _load_tool("max_seed_study", str(path)).main()
    with open(tmp_path / "OUR_SUP_MAX_seeds_r05.json") as f:
        want = json.load(f)
    want_built = _configs(recorder.built)
    assert seeds == list(max_seed_study.SEEDS)

    recorder.built, seeds[:] = [], []
    out = tmp_path / "out"
    monkeypatch.setattr(max_seed_study, "load_cora",
                        lambda seed: seeds.append(seed) or ds)
    monkeypatch.setattr(max_seed_study, "Trainer", recorder)
    max_seed_study.main(["--device", "cpu", "--out", str(out)])
    with open(out / max_seed_study.OUT_FILE) as f:
        got = json.load(f)
    assert seeds == list(max_seed_study.SEEDS)
    assert _configs(recorder.built) == want_built
    _keys_match(got, want, EXTRAS["max_seed_study"])
    assert got["protocol"] == want["protocol"]
    assert got["seeds"] == want["seeds"]
    assert got["summary"] == want["summary"]
    assert sorted(os.listdir(tmp_path)) == ["OUR_SUP_MAX_seeds_r05.json",
                                            "out", "tools"]


def test_max_seed_study_trains(graphs):
    """Two seeds with the real Trainer, 2 epochs: the rows are the
    trainers', and the summary holds the CI at t(1, .975)."""
    ds, _ = graphs
    trainers = []
    rec = max_seed_study.run(ds, seeds=(1, 7), epochs=2, device="cpu",
                             trainers=trainers)
    vals = np.array([tr.max_vali_f1 for tr in trainers])
    assert [tr.tcfg.seed for tr in trainers] == [1, 7]
    assert rec["seeds"]["7"]["best_val_f1"] == round(vals[1], 4)
    assert rec["summary"] == {
        "mean_val_f1": round(float(vals.mean()), 4),
        "std": round(float(vals.std(ddof=1)), 4),
        "ci95_halfwidth": round(float(12.706 * vals.std(ddof=1)
                                      / np.sqrt(2)), 4)}
    assert rec["dataset"] == "powerlaw2000 (stand-in: synthetic graph and " \
                             "content)"


def test_prefetch_bench_against_the_tool(graphs, monkeypatch, tmp_path,
                                         capsys, recorder):
    """The tool's main and the port's main, their Trainer replaced: the
    trainers' configs (depth 0, then 2), the warm and timed epochs, the
    record's keys and fields; the port writes ``--out`` only when given."""
    ds, jds = graphs
    argv = ["--epochs", "2", "--b_sz", "64", "--learn_method", "unsup"]
    monkeypatch.setattr(jax_data, "load_cora", lambda: jds)
    monkeypatch.setattr(jax_train, "Trainer", recorder)
    monkeypatch.setattr(sys, "argv", ["prefetch_bench.py"] + argv +
                        ["--out", str(tmp_path / "tool.json")])
    capsys.readouterr()
    _load_tool("prefetch_bench").main()
    want = json.loads(capsys.readouterr().out)
    with open(tmp_path / "tool.json") as f:
        assert json.load(f) == want
    want_built = _configs(recorder.built)
    assert [c[1]["prefetch_depth"] for c in want_built] == [0, 2]

    recorder.built = []
    monkeypatch.setattr(prefetch_bench, "load_cora", lambda: ds)
    monkeypatch.setattr(prefetch_bench, "Trainer", recorder)
    cwd = tmp_path / "cwd"
    os.makedirs(cwd)
    monkeypatch.chdir(cwd)
    prefetch_bench.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert os.listdir(cwd) == []
    prefetch_bench.main(argv + ["--device", "cpu", "--out", "port.json"])
    assert os.listdir(cwd) == ["port.json"]
    assert _configs(recorder.built)[:2] == want_built
    _keys_match(got, want, EXTRAS["prefetch_bench"])
    for key in ("dataset", "b_sz", "learn_method"):
        assert got[key] == want[key]
    assert isinstance(got["speedup"], float) and got["speedup"] > 0


@pytest.mark.parametrize("method", ["sup", "unsup"])
def test_prefetch_depths_end_bit_equal(graphs, method):
    """With the real Trainer, depths 0 and 2 end with the same params bit
    for bit (the prefetch thread changes no arithmetic)."""
    ds, _ = graphs
    keep = {}
    rec = prefetch_bench.run(ds, "standin", epochs=1, b_sz=128,
                             learn_method=method, device="cpu", keep=keep)
    assert len(keep["params"][0]) == len(keep["params"][2]) > 0
    for a, b in zip(keep["params"][0], keep["params"][2]):
        assert torch.equal(a, b)
    assert rec["epoch_s_serial"] == round(keep["epoch_s"][0], 3)


# ------------------------------------------------------------ profile_dense

def test_profile_dense_programs_against_the_tool(graphs, monkeypatch, capsys,
                                                 jit_calls):
    """The tool's three jitted programs (2 steps of 16, cap 8, its 2 x 128
    model) and the port's, from the tool's params with its draws replayed:
    full_step's losses and params, forward_only's sums, sampling_only's
    sums exact, each call alike; the printed lines' shape."""
    ds, jds = graphs
    names = {"full_step": "make_dense_sup_epoch.<locals>.epoch",
             "forward_only": "main.<locals>.fwd_epoch",
             "sampling_only": "main.<locals>.samp_epoch"}
    for name in names.values():
        jit_calls[name] = []
    monkeypatch.setattr(jax_data, "load_cora", lambda: jds)
    monkeypatch.setattr(sys, "argv", ["profile_dense.py", "--cap", "8",
                                      "--batch", "16", "--steps", "2"])
    capsys.readouterr()
    _load_tool("profile_dense").main()
    tool_lines = capsys.readouterr().out.strip().splitlines()
    full = jit_calls[names["full_step"]]
    assert all(len(jit_calls[n]) == 2 for n in names.values())
    init, _, neighbors, degrees, batches, _, key = full[0][0]
    tables = types.SimpleNamespace(neighbors=np.asarray(neighbors),
                                   degrees=np.asarray(degrees))
    keys = _hops_after(key, batches.shape[0], 2)

    keep, lines = {}, []
    profile_dense.run(ds, cap=8, batch=16, steps=2, device="cpu",
                      params=init, hop_for=lambda name: JaxHop(keys, tables),
                      keep=keep, log=lines.append)
    assert [_shape(x) for x in lines] == [_shape(x) for x in tool_lines]
    assert [x.split(":")[0] for x in lines] == list(names)
    want_params, want_losses = full[1][1]
    np.testing.assert_allclose(keep["full_step"].numpy(),
                               np.asarray(want_losses), rtol=LOSS_RTOL)
    _assert_params_close(keep["params"], want_params, PARAM_ATOL)
    np.testing.assert_allclose(keep["forward_only"].numpy(),
                               np.asarray(jit_calls[names["forward_only"]][1][1]),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(
        keep["sampling_only"].numpy(),
        np.asarray(jit_calls[names["sampling_only"]][1][1]))


# ------------------------------------------------------------ the mains

MAINS = {
    "validate_cached": (validate_cached, ["--epochs", "1"],
                        {"load_dataset": load_dataset}),
    "staleness_quality": (staleness_quality, [],
                          {"load_cora": load_cora,
                           "load_pubmed": load_pubmed}),
    "max_seed_study": (max_seed_study, [], {"load_cora": load_cora}),
    "prefetch_bench": (prefetch_bench, [], {"load_cora": load_cora}),
    "profile_dense": (profile_dense, [], {"load_cora": load_cora}),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_raises_without_dataset_or_card(name, monkeypatch, tmp_path):
    """No card and no --device: RuntimeError before anything is loaded.
    --device cpu and no data: the loader's FileNotFoundError naming the
    missing file (the loaders pointed at an empty directory); nothing is
    written."""
    module, argv, loaders = MAINS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = ["--out", str(tmp_path / "out")] if name in (
        "staleness_quality", "max_seed_study") else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv + out)
    for attr, loader in loaders.items():
        monkeypatch.setattr(module, attr, functools.partial(
            loader, root=str(tmp_path / "data")))
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(tmp_path / "data"))):
        module.main(argv + out + ["--device", "cpu"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["validate_cached", "profile_dense"])
def test_printing_mains_write_nothing(name, graphs, monkeypatch, tmp_path,
                                      capsys):
    """validate_cached and profile_dense print their lines and write no
    file (1 epoch on a 300-node graph; profile_dense 1 step of 8)."""
    ds, _ = graphs
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    if name == "validate_cached":
        validate_cached.main(["--dataSet", "powerlaw:300:1500", "--epochs",
                              "1", "--hidden", "8", "--b_sz", "64",
                              "--device", "cpu"])
        want = ["epoch #: loss # val_f# # test_f# #",
                "BEST val # test # (#s wall)"]
    else:
        monkeypatch.setattr(profile_dense, "load_cora", lambda: ds)
        profile_dense.main(["--steps", "1", "--batch", "8", "--cap", "4",
                            "--device", "cpu"])
        want = [f"{p}: # ms/step" for p in profile_dense.PROGRAMS]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [_shape(x) for x in lines] == want
    assert os.listdir(tmp_path) == []
