"""The port's collectives (graphsage_torch.parallel.comm) and process-group
initialization (parallel.multihost) on gloo ranks, on the CPU.

Each world size runs once in ``tests/torch_dist_worker.py`` (one process a
rank); the results are held to what the JAX package's ``shard_map``
collectives compute, written out in numpy:

- all_to_all_rows (``lax.all_to_all(split_axis=0, concat_axis=0,
  tiled=False)``): y_r[q] = x_q[r]; its gradient is the reverse exchange,
  dx_r[q] = cot_q[r];
- all_gather_rows (``lax.all_gather(tiled=True)``): the ranks' rows
  stacked; its gradient is the SUM reduce-scatter (``psum_scatter``);
- mean_over_ranks: the mean of the ranks' tensors (``pmean``);
- all_gather_cols (the tensor-parallel join, GSPMD's all-gather of column
  slices): the ranks' columns side by side; its gradient is the SUM
  reduce-scatter of the column slices;
- sum_partials (GSPMD's all-reduce of partial products): the sum of the
  ranks' tensors; its gradient is each rank's own cotangent.

The exchanges are copies, exact in float32 and bfloat16 (a bfloat16
gradient of a float32 cotangent is the cotangent rounded).  The sums (the
reduce-scatter, the mean) add at most 4 terms in the backend's order: float32
within rtol 1e-6 of numpy's order, bfloat16 within P bf16 ulps of the sum
of the terms' magnitudes (each add rounds to bfloat16).
"""

import socket

import numpy as np
import pytest
import torch

from graphsage_torch.parallel import multihost
from tests.torch_dist_worker import run_ranks


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def ranks(request):
    world = request.param
    out = run_ranks([("comm", "comm", {"seed": 5})], world)
    return world, [r["comm"] for r in out]


def _as(dtype: str, x: np.ndarray) -> np.ndarray:
    """x rounded to ``dtype`` (a bfloat16 gradient of a float32 cotangent
    is the cotangent rounded)."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_to_all_rows_forward_and_backward(ranks, dtype):
    world, res = ranks
    for r in range(world):
        for q in range(world):
            np.testing.assert_array_equal(res[r][dtype]["y"][q],
                                          res[q][dtype]["x"][r])
            np.testing.assert_array_equal(res[r][dtype]["dx"][q],
                                          _as(dtype, res[q][dtype]["cot"][r]))


def test_all_to_all_rows_int32_requests(ranks):
    world, res = ranks
    for r in range(world):
        assert res[r]["int32"]["y"].dtype == np.int32
        for q in range(world):
            np.testing.assert_array_equal(res[r]["int32"]["y"][q],
                                          res[q]["int32"]["x"][r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_gather_rows_forward_and_reduce_scatter_backward(ranks, dtype):
    world, res = ranks
    want = np.concatenate([res[q][dtype]["z"] for q in range(world)])
    for r in range(world):
        np.testing.assert_array_equal(res[r][dtype]["full"], want)
        # d z_r = sum over ranks q of cot2_q at rank r's rows (float32
        # cotangents, so the bf16 gradient is their float32 sum rounded)
        # (each rank's cotangent reaches the collective rounded to dtype,
        # which sums in dtype)
        rows = slice(2 * r, 2 * r + 2)
        terms = [_as(dtype, res[q][dtype]["cot2"][rows])
                 for q in range(world)]
        got = res[r][dtype]["dz"]
        if dtype == "float32":
            np.testing.assert_allclose(got, sum(terms), rtol=1e-6,
                                       atol=1e-6)
        else:
            # each add rounds once, by at most an ulp of the sum of the
            # terms' magnitudes (the partial sums may cancel)
            mag = sum(np.abs(t) for t in terms)
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
            assert (np.abs(got - sum(terms)) <= world * ulp).all()


def _assert_sum(got: np.ndarray, terms: list, dtype: str, world: int):
    """got is the sum of terms, added in the backend's order: float32
    within rtol 1e-6, bfloat16 within P ulps of the terms' magnitudes."""
    if dtype == "float32":
        np.testing.assert_allclose(got, sum(terms), rtol=1e-6, atol=1e-6)
        return
    mag = sum(np.abs(t) for t in terms)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert (np.abs(got - sum(terms)) <= world * ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_gather_cols_forward_and_reduce_scatter_backward(ranks, dtype):
    world, res = ranks
    want = np.concatenate([res[q][dtype]["c"] for q in range(world)],
                          axis=1)
    for r in range(world):
        np.testing.assert_array_equal(res[r][dtype]["cols"], want)
        cols = slice(2 * r, 2 * r + 2)
        _assert_sum(res[r][dtype]["dc"],
                    [_as(dtype, res[q][dtype]["cot3"][:, cols])
                     for q in range(world)], dtype, world)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sum_partials_forward_and_identity_backward(ranks, dtype):
    world, res = ranks
    terms = [res[q][dtype]["s"] for q in range(world)]
    for r in range(world):
        _assert_sum(res[r][dtype]["summed"], terms, dtype, world)
        np.testing.assert_array_equal(res[r][dtype]["summed"],
                                      res[0][dtype]["summed"])
        np.testing.assert_array_equal(res[r][dtype]["ds"],
                                      _as(dtype, res[r][dtype]["cot4"]))


def test_mean_over_ranks(ranks):
    world, res = ranks
    for i, key in enumerate(("a", "b")):
        want = sum(res[q]["mean"][key] for q in range(world)) / world
        for r in range(world):
            np.testing.assert_allclose(res[r]["mean"]["got"][i], want,
                                       rtol=1e-6, atol=1e-7)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_size_without_rendezvous_raises(monkeypatch):
    """WORLD_SIZE > 1 with no rendezvous named must not run as world 1."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for name in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="refusing to run as world 1"):
        multihost.initialize("cpu", timeout_s=2)


def test_unreachable_peer_raises_instead_of_world_1(monkeypatch):
    """A 2-rank job whose rendezvous nobody serves raises after the
    group's timeout instead of running as world 1."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="could not form the 2-process"):
        multihost.initialize("cpu", timeout_s=2)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_initialize_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
