"""The port's fault handling (graphsage_torch.utils.obs): the metrics sink,
the deadline-guarded fetch, the first-step watchdog and the test wedge, as
tests/test_obs.py holds the JAX package's; the trainers' fetches all
going through the deadline guard; the profiler trace and the NaN checks;
the spans and counters of training and serving, on while a profiler
records and on its timeline."""

import contextlib
import io
import json
import re
import threading
import time
import timeit

import numpy as np
import pytest
import torch

import graphsage_torch.train.cached_trainer as cached_trainer_mod
import graphsage_torch.train.trainer as trainer_mod
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.infer import full_graph_embeddings
from graphsage_torch.models import GraphSageConfig
from graphsage_torch.train import CachedTrainer, Trainer, TrainConfig
from graphsage_torch.train.optim import tree_leaves
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


# ------------------------------------------------------------------ spans

def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def store():
    """The span store, empty before and after the test."""
    obs.records(clear=True)
    yield
    obs.records(clear=True)


def _spans(rec, name):
    return [s for s in rec["spans"] if s["name"] == name]


def _check_on_the_timeline(prof, rec):
    """Every main-thread record has its gs: event in the profile, inside
    the record's own stamps (50 µs for the two clocks), of the same
    duration (10% or 50 µs) and start (0.5 ms, on the Unix clock).  A
    thread the system takes off its core between a stamp and its event's
    lengthens the record by the time it was off: one record in twenty (at
    least one) may differ so."""
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith(obs.SPAN_PREFIX):
            events.setdefault(e.name[len(obs.SPAN_PREFIX):], []).append(e)
    main = [s for s in rec["spans"] if s["thread"] == "MainThread"]
    assert main
    apart = []
    for name in {s["name"] for s in main}:
        mine = sorted(_spans({"spans": main}, name),
                      key=lambda s: s["start_ns"])
        theirs = sorted(events.get(name, []),
                        key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            dur_us = e.time_range.elapsed_us()
            at_ns = start_ns + e.time_range.start * 1e3
            assert s["start_ns"] - 5e4 <= at_ns, name
            assert at_ns + dur_us * 1e3 <= s["end_ns"] + 5e4, name
            if (abs(s["host_ms"] * 1e3 - dur_us) > max(0.1 * dur_us, 50.0)
                    or abs(at_ns - s["start_ns"]) > 5e5):
                apart.append((name, s["host_ms"], dur_us))
    assert len(apart) <= max(1, len(main) // 20), apart


def test_spans_are_off_and_cheap_without_a_profiler(store):
    """No profiler: nothing is stored, one shared no-op is returned, and a
    use costs no more than three empty ``with contextlib.nullcontext()``
    blocks timed in the same process (about one, 0.4-0.5 µs, on a CPU
    host)."""
    def use():
        with obs.span("x", rows=3) as s:
            s.note(more=1)
        obs.count("y")

    def empty():
        with contextlib.nullcontext():
            pass

    use()
    assert obs.span("a") is obs.span("b", device=torch.device("cpu"))
    assert obs.records() == {"spans": [], "counts": {}}
    # the least of many short runs: the cost where no other process held
    # the core
    n = 1000
    per_use = min(timeit.repeat(use, number=n, repeat=200)) / n / 2
    baseline = min(timeit.repeat(empty, number=n, repeat=200)) / n
    assert per_use <= 3 * baseline, (per_use, baseline)


def test_cached_epoch_spans(small, store):
    tr = _trainer(small, cls=CachedTrainer)
    tr.train_epoch()                    # warm, untraced: stores nothing
    assert obs.records()["spans"] == []
    with _cpu_profile() as prof:
        tr.train_epoch()
    rec = obs.records()
    steps = len(tr.step_losses)
    assert steps > 1
    batches = _spans(rec, "train.batches")
    assert len(batches) == 1
    assert batches[0]["counts"] == {"rows": len(small.train_nodes)}
    for name, n, parent in (("train.refresh", 1, None),
                            ("step.sample", steps, None),
                            ("step.forward", steps, None),
                            ("step.layer1", steps, "step.forward"),
                            ("step.backward", steps, None),
                            ("step.optimizer", steps, None),
                            ("train.loss_fetch", 1, None)):
        found = _spans(rec, name)
        assert len(found) == n, name
        assert {s["parent"] for s in found} == {parent}, name
    assert {s["counts"]["full_table"] for s in _spans(rec, "step.layer1")
            } <= {0, 1}
    assert all(s["device_ms"] is None for s in rec["spans"])
    _check_on_the_timeline(prof, rec)


def test_compact_epoch_spans_on_the_prefetch_thread(small, store):
    tr = _trainer(small, prefetch_depth=2, learn_method="plus_unsup")
    with _cpu_profile() as prof:
        tr.train_epoch()
    rec = obs.records()
    steps = len(tr.step_losses)
    assert steps > 1
    host = _spans(rec, "train.host_batch")
    assert len(host) == steps
    assert {s["thread"] for s in host} == {"gs-batch-prefetch"}
    assert all(0 < s["counts"]["unique"] <= s["counts"]["padded"]
               for s in host)
    waits = _spans(rec, "prefetch.wait")
    assert {s["thread"] for s in waits} == {"MainThread"}
    assert len(waits) == steps + 1      # and the end of the queue
    assert rec["counts"]["prefetch.gets"] == steps
    assert 0 <= rec["counts"].get("prefetch.starved", 0) <= steps
    for name in ("step.upload", "step.forward", "step.backward",
                 "step.optimizer", "train.loss_fetch"):
        assert len(_spans(rec, name)) == steps, name
    _check_on_the_timeline(prof, rec)
    # the producer's state follows its owner's: off once the profile ends
    obs.records(clear=True)
    tr.train_epoch()
    assert obs.records() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("agg", ["MEAN", "MAX"])
def test_serving_pass_spans(small, store, agg):
    from graphsage_torch.models.graphsage import init_graphsage
    mcfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8,
                           agg_func=agg)
    params = init_graphsage(torch.Generator().manual_seed(0), mcfg)
    pad = small.graph.to_padded()
    with _cpu_profile() as prof:
        full_graph_embeddings(params, mcfg, small.features, pad,
                              device="cpu")
    rec = obs.records()
    for name in ("serve.transform", "serve.aggregate"):
        assert sorted(s["counts"]["layer"] for s in _spans(rec, name)) == [
            0, 1], name
    assert {s["counts"]["rows"] for s in _spans(rec, "serve.aggregate")
            } == {small.num_nodes}
    _check_on_the_timeline(prof, rec)


@pytest.mark.parametrize("cls", [Trainer, CachedTrainer],
                         ids=["compact", "cached"])
def test_traced_epochs_equal_untraced_ones(small, store, cls):
    """Spans read nothing the step computes: the losses and parameters of
    a traced epoch equal an untraced one's bit for bit."""
    kw = {"prefetch_depth": 2} if cls is Trainer else {}
    plain, traced = (_trainer(small, cls=cls, learn_method="plus_unsup",
                              **kw) for _ in range(2))
    plain.train_epoch()
    with _cpu_profile():
        traced.train_epoch()
    assert obs.records()["spans"]
    assert plain.step_losses == traced.step_losses
    for a, b in zip(tree_leaves(plain.params), tree_leaves(traced.params)):
        assert torch.equal(a, b)


def test_a_carried_state_is_refreshed_by_its_owner(store):
    """A worker thread's spans follow the state its owner last handed on."""
    carried = obs.Carry()
    assert not carried.on
    seen = []

    def worker():
        with carried:
            with obs.span("w"):
                obs.count("w")
            seen.append(len(obs.records()["spans"]))

    with _cpu_profile():
        carried.refresh()
    t = threading.Thread(target=worker, name="w")
    t.start()
    t.join(10)
    assert not t.is_alive() and seen == [1]
    carried.refresh()           # the owner's profile has ended: off again
    t = threading.Thread(target=worker, name="w")
    t.start()
    t.join(10)
    assert not t.is_alive() and seen == [1, 1]
    assert obs.records()["counts"] == {"w": 1}
