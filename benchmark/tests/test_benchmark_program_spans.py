"""The readers of the metrics the port's own spans and counters give
(``graphsage_torch.utils.obs``): each reads its number from a filled store
in a traced slice, and nothing on the CPU (no device work) or from an
empty store (a program without the spans)."""

import time

import pytest

from benchmark import harness, trace
from graphsage_torch.utils import obs


def span(name, host_ms, device_ms=None, **counts):
    return {"name": name, "thread": "MainThread", "parent": None,
            "start_ns": 0, "end_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": device_ms, "counts": counts}


STORE = {
    "spans": [span("train.batches", 300.0, rows=8),
              span("train.batches", 340.0, rows=8),
              span("train.host_batch", 4.0), span("train.host_batch", 6.0),
              span("prefetch.wait", 2.0), span("prefetch.wait", 4.0),
              span("prefetch.wait", 0.0),
              span("step.sample", 1.0), span("step.sample", 3.0),
              span("step.forward", 2.0), span("step.backward", 3.0),
              span("step.optimizer", 0.5),
              span("step.layer1", 0.2, device_ms=9.0, full_table=1),
              span("step.layer1", 0.2, device_ms=11.0, full_table=1),
              span("serve.transform", 0.1, device_ms=7.5, layer=0),
              span("serve.transform", 0.1, device_ms=8.5, layer=0),
              span("serve.transform", 0.1, device_ms=1.0, layer=1),
              span("serve.aggregate", 0.1, layer=0, rows=8)],
    "counts": {"prefetch.gets": 2, "prefetch.starved": 1},
}

EXPECTED = {
    ("batch_prep_ms.train", "train_sup_pl1m_b65536"): 320.0,
    ("host_batch_ms.train", "train_plus_unsup_pubmed_b20"): 5.0,
    ("prefetch_wait_ms.train", "train_plus_unsup_pubmed_b20"): 3.0,
    ("prefetch_starved.train", "train_plus_unsup_pubmed_b20"): 50.0,
    ("dispatch_ms.train", "train_sup_pl1m_b65536"): 2.0 + 2.0 + 3.0 + 0.5,
    ("layer1_ms.train", "train_sup_pl1m_b65536"): 10.0,
    ("transform_ms.embed", "embed_pl1m_cap16"): 8.0 + 1.0,
}


def ctx(cell, busy_s):
    result = trace.TraceResult(ticks=1, window_s=1.0, busy_s=busy_s,
                               kernels=0, device_ops={}, idle_gaps=[],
                               spans_ms={})
    return harness.Ctx(harness.load_cell(cell), result, {}, {})


@pytest.mark.parametrize("metric,cell", sorted(EXPECTED))
def test_reader_reads_the_store(metric, cell, monkeypatch):
    read = harness.reader(metric)
    monkeypatch.setattr(obs, "records", lambda clear=False: STORE)
    assert read(ctx(cell, 0.5)) == pytest.approx(EXPECTED[metric, cell])
    # on the CPU the slice holds no device work: nothing to read
    assert read(ctx(cell, 0.0)) is None
    monkeypatch.setattr(obs, "records",
                        lambda clear=False: {"spans": [], "counts": {}})
    assert read(ctx(cell, 0.5)) is None


@pytest.mark.parametrize("metric,cell", sorted(EXPECTED))
def test_every_reader_is_listed_for_its_cells(metric, cell):
    assert metric in {m["name"] for m in harness.load_cell(cell).per_layer}


def test_host_readers_read_a_profiled_store():
    """The host-clock readers on spans the program stored under a CPU
    profile (the device-timed ones need a card's events)."""
    from torch.profiler import ProfilerActivity, profile

    obs.records(clear=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with obs.span("train.batches", rows=8):
                    time.sleep(0.002)
                with obs.span("step.sample"):
                    time.sleep(0.001)
                obs.count("prefetch.gets")
        got = harness.reader("batch_prep_ms.train")(
            ctx("train_sup_pl1m_b65536", 0.5))
        assert 2.0 <= got < 50.0
        got = harness.reader("dispatch_ms.train")(
            ctx("train_sup_pl1m_b65536", 0.5))
        assert 1.0 <= got < 50.0
        assert harness.reader("prefetch_starved.train")(
            ctx("train_plus_unsup_pubmed_b20", 0.5)) == 0.0
        assert harness.reader("layer1_ms.train")(
            ctx("train_sup_pl1m_b65536", 0.5)) is None
    finally:
        obs.records(clear=True)
