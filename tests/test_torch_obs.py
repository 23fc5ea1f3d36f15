"""The port's fault handling (graphsage_torch.utils.obs): the metrics sink,
the deadline-guarded fetch, the first-step watchdog and the test wedge, as
tests/test_obs.py holds the JAX package's; the trainers' fetches all
going through the deadline guard; the profiler trace and the NaN checks."""

import io
import json
import re
import time

import numpy as np
import pytest
import torch

import graphsage_torch.train.cached_trainer as cached_trainer_mod
import graphsage_torch.train.trainer as trainer_mod
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import CachedTrainer, Trainer, TrainConfig
from graphsage_torch.utils import obs
from graphsage_torch.utils.obs import (FetchDeadlineError, MetricsLogger,
                                       collective_watchdog,
                                       fetch_with_deadline,
                                       maybe_inject_test_wedge)


def test_metrics_logger_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path))
    log.log("epoch", epoch=0, loss=1.5)
    log.log("eval", val_f1=0.9)
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["event"] for e in events] == ["epoch", "eval"]
    assert events[0]["loss"] == 1.5
    assert MetricsLogger().log("x", a=1)["a"] == 1


def test_watchdog_silent_when_step_completes():
    buf = io.StringIO()
    with collective_watchdog(timeout_s=5.0, stream=buf) as state:
        pass
    time.sleep(0.05)
    assert not state["fired"]
    assert buf.getvalue() == ""


def test_watchdog_fires_with_device_diagnostics():
    buf = io.StringIO()
    with collective_watchdog(label="test step", timeout_s=0.05,
                             stream=buf) as state:
        time.sleep(0.4)
    assert state["fired"]
    out = buf.getvalue()
    assert "test step" in out and "process" in out
    assert "devices: cpu" in out and "hung in a kernel" in out


def test_watchdog_env_timeout(monkeypatch):
    monkeypatch.setenv("GS_WATCHDOG_TIMEOUT_S", "0.05")
    buf = io.StringIO()
    with collective_watchdog(stream=buf) as state:
        time.sleep(0.4)
    assert state["fired"]
    assert "0.05s" in buf.getvalue()


def test_fetch_with_deadline_healthy_path():
    assert fetch_with_deadline(torch.tensor(2.5), timeout_s=30.0) == 2.5
    arr = fetch_with_deadline(torch.arange(3), convert=np.asarray,
                              timeout_s=30.0)
    assert list(arr) == [0, 1, 2]
    assert fetch_with_deadline(torch.tensor([1.0, 2.0]),
                               convert=torch.Tensor.tolist,
                               timeout_s=30.0) == [1.0, 2.0]


def test_fetch_with_deadline_raises_on_stall():
    buf = io.StringIO()

    def stall(_):
        time.sleep(30)
        return 0.0

    t0 = time.monotonic()
    with pytest.raises(FetchDeadlineError, match="step 400 loss fetch"):
        fetch_with_deadline(torch.tensor(1.0), label="step 400 loss fetch",
                            timeout_s=0.1, convert=stall, stream=buf)
    assert time.monotonic() - t0 < 5.0, "deadline did not bound the wait"
    out = buf.getvalue()
    assert "wedged" in out and "kill this process" in out
    assert "devices: cpu" in out


def test_fetch_with_deadline_propagates_worker_error():
    def boom(_):
        raise ValueError("inner failure")

    with pytest.raises(ValueError, match="inner failure"):
        fetch_with_deadline(torch.tensor(1.0), timeout_s=5.0, convert=boom)


def test_fetch_with_deadline_env_timeout(monkeypatch):
    monkeypatch.setenv("GS_FETCH_TIMEOUT_S", "0.1")
    with pytest.raises(FetchDeadlineError, match="0.1s"):
        fetch_with_deadline(1.0, convert=lambda _: time.sleep(30),
                            stream=io.StringIO())


def test_test_wedge_fires_once_per_sentinel(tmp_path, monkeypatch):
    maybe_inject_test_wedge(1)          # no variable: a no-op
    sentinel = tmp_path / "wedge"
    monkeypatch.setenv("GS_TEST_WEDGE_SENTINEL", str(sentinel))
    maybe_inject_test_wedge(0)          # epoch 0: nothing checkpointed yet
    assert not sentinel.exists()
    with pytest.raises(FetchDeadlineError, match="injected test wedge"):
        maybe_inject_test_wedge(1)
    assert sentinel.exists()
    maybe_inject_test_wedge(1)          # the relaunched run trains through
    maybe_inject_test_wedge(2)


@pytest.fixture(scope="module")
def small():
    return synthetic_power_law(120, 500, num_feats=12, num_classes=3,
                               seed=0)


def _trainer(ds, cls=Trainer, **kw):
    mcfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8)
    tcfg = TrainConfig(**{"epochs": 1, "b_sz": 16, "fanout": 3, "seed": 1,
                          "verbose": False, "prefetch_depth": 0, **kw})
    extra = {"table_cap": 8} if cls is CachedTrainer else {}
    return cls(ds, mcfg, tcfg, device="cpu", **extra)


def test_compact_trainer_first_step_warmup_guard(small, monkeypatch):
    labels = []
    real = trainer_mod.collective_watchdog

    def recording(label="", **kw):
        labels.append(label)
        return real(label=label, **kw)

    monkeypatch.setattr(trainer_mod, "collective_watchdog", recording)
    tr = _trainer(small)
    assert not tr._warmed
    tr.train_epoch()
    assert tr._warmed
    tr.train_epoch()
    assert len(labels) == 1 and "first train step" in labels[0]


def _count_fetches(monkeypatch, module):
    calls = []

    def counting(value, label="", **kw):
        calls.append(label)
        return fetch_with_deadline(value, label=label, **kw)

    monkeypatch.setattr(module, "fetch_with_deadline", counting)
    return calls


@pytest.mark.parametrize("verbose", [False, True], ids=["quiet", "verbose"])
def test_compact_trainer_fetches_through_the_deadline(small, monkeypatch,
                                                      verbose):
    """Every step's loss is fetched once, in step order, through the
    deadline guard; the first step's under the warmup watchdog."""
    calls = _count_fetches(monkeypatch, trainer_mod)
    tr = _trainer(small, verbose=verbose, b_sz=8)
    tr.train_epoch()
    steps = len(tr.step_losses)
    assert steps == int(np.ceil(len(small.train_nodes) / 8)) > 4
    assert calls == ["step 1 loss fetch (warmup)"] + [
        f"step {i + 1} loss fetch" for i in range(1, steps)]
    tr.train_epoch()            # warm: no warmup fetch
    assert calls[steps:] == [f"step {i + 1} loss fetch"
                             for i in range(steps)]
    assert all(isinstance(loss, float) for loss in tr.step_losses)


@pytest.mark.parametrize("verbose", [False, True], ids=["quiet", "verbose"])
def test_compact_step_copies_its_batch_before_it_launches(small,
                                                          monkeypatch,
                                                          verbose):
    """A copy to the card waits for all queued work, outside any deadline,
    so each step copies its whole batch (c) before it launches its encode
    (e) and update (u), and its loss is fetched under the deadline (f)
    before the next step's copies: a hang in a step surfaces at a guarded
    fetch, never inside a copy."""
    events = []
    for name, tag in (("_to_device", "c"), ("graphsage_apply_gathered", "e"),
                      ("apply_gradients", "u"), ("fetch_with_deadline", "f")):
        def spy(*args, _fn=getattr(trainer_mod, name), _tag=tag, **kw):
            events.append(_tag)
            return _fn(*args, **kw)
        monkeypatch.setattr(trainer_mod, name, spy)
    tr = _trainer(small, learn_method="plus_unsup", verbose=verbose, b_sz=8)
    events.clear()              # the feature table's copy at construction
    tr.train_epoch()
    steps = len(tr.step_losses)
    assert steps > 4
    assert re.fullmatch(f"(c+euf){{{steps}}}", "".join(events)), events


def test_trainer_steady_state_fetch_guarded(small, monkeypatch):
    """A stalled fetch fails the epoch loudly instead of hanging it."""
    _trainer(small).train_epoch()   # a healthy epoch passes the guard

    def wedge_every_fetch(value, label="", **kw):
        raise obs.FetchDeadlineError(f"simulated wedge: {label}")

    monkeypatch.setattr(trainer_mod, "fetch_with_deadline",
                        wedge_every_fetch)
    with pytest.raises(FetchDeadlineError, match="simulated wedge"):
        _trainer(small).train_epoch()


def test_cached_trainer_epoch_fetch_guarded(small, monkeypatch):
    calls = _count_fetches(monkeypatch, cached_trainer_mod)
    tr = _trainer(small, cls=CachedTrainer, epochs=2)
    tr.fit()
    assert calls == ["cached epoch 0 loss fetch",
                     "cached epoch 1 loss fetch"]
    assert len(tr.step_losses) > 1


def test_fit_injects_the_test_wedge_at_epoch_one(small, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("GS_TEST_WEDGE_SENTINEL", str(tmp_path / "w"))
    tr = _trainer(small, epochs=3)
    with pytest.raises(FetchDeadlineError, match="injected"):
        tr.fit()
    assert [h["epoch"] for h in tr.history] == [0]
    tr.fit()                    # from epoch 1 again: the wedge fired once
    assert [h["epoch"] for h in tr.history] == [0, 1, 2]


def test_profile_writes_a_trace(tmp_path):
    """profile(log_dir) writes the block's torch.profiler trace (Chrome
    JSON) into log_dir, at the path it yields."""
    with obs.profile(str(tmp_path / "trace")) as path:
        torch.randn(32, 32).matmul(torch.randn(32, 32)).sum()
    assert path.startswith(str(tmp_path / "trace"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


class _NanBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_enable_nan_checks_raises_on_a_nan_in_the_backward():
    """With the checks on, a backward that returns NaN raises, naming the
    function; with them off, the NaN passes silently into the gradient."""
    x = torch.ones(3, requires_grad=True)
    obs.enable_nan_checks(True)
    try:
        with pytest.raises(RuntimeError, match="_NanBackward.*nan"):
            _NanBackward.apply(x).sum().backward()
    finally:
        obs.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    _NanBackward.apply(x).sum().backward()
    assert torch.isnan(x.grad).all()
