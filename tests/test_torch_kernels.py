"""The CUDA kernels of graphsage_torch.ops.aggregate against their plain
versions, and what the kernel wrappers refuse.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX.  There the ``gpu`` tests run; elsewhere they skip:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerances on the card: float32 rtol=atol=1e-5; bfloat16 within 2 bf16 ulps
(the kernel and the plain version may sum in different orders); MAX exact.
"""

import numpy as np
import pytest
import torch

from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import build

CASES = {
    "random": dict(u=37, s=11, m=53, d=19),
    "tail600": dict(u=16, s=5, m=64, d=600),
    "unaligned": dict(u=3, s=7, m=11, d=130),
    "empty_rows": dict(u=12, s=6, m=20, d=33),
    "many_slots": dict(u=40, s=45, m=70, d=40),   # more slots than a warp
    "wide602": dict(u=64, s=32, m=500, d=602),    # MAX layer-1 row width
}


def _case(name, seed=0):
    c = CASES[name]
    rng = np.random.RandomState(seed)
    embed = rng.randn(c["m"], c["d"]).astype(np.float32)
    idx = rng.randint(0, c["m"], (c["u"], c["s"])).astype(np.int32)
    mask = (rng.rand(c["u"], c["s"]) < 0.7).astype(np.float32)
    if name == "empty_rows":
        mask[[0, 5, 11]] = 0.0
    return embed, idx, mask


def _args(**change):
    args = dict(embed=torch.zeros(10, 6),
                idx=torch.zeros(4, 3, dtype=torch.int32),
                mask=torch.ones(4, 3))
    args.update(change)
    return args


@pytest.mark.parametrize("args,error,match", [
    (_args(idx=torch.zeros(4, 3, dtype=torch.int64)), TypeError, "idx"),
    (_args(mask=torch.ones(4, 3, dtype=torch.bfloat16)), TypeError, "mask"),
    (_args(embed=torch.zeros(10, 6, dtype=torch.float64)), TypeError,
     "embed"),
    (_args(embed=torch.zeros(6, 10).T), ValueError, "column stride"),
    (_args(idx=torch.zeros(3, 4, dtype=torch.int32).T), ValueError,
     "contiguous"),
    (_args(mask=torch.ones(4, 2)), ValueError, "expected"),
    (_args(), ValueError, "CUDA device"),
], ids=["idx-int64", "mask-bf16", "embed-f64", "embed-strided-cols",
        "idx-transposed", "mask-shape", "cpu-tensors"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(args, error,
                                                              match):
    with pytest.raises(error, match=match):
        agg._check_kernel_args(**args)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    embed, idx, mask = _case("random")
    e, i, m = (torch.from_numpy(x) for x in (embed, idx, mask))
    before = dict(agg.LAUNCHES)
    assert torch.equal(agg.mean_aggregate(e, i, m),
                       agg.mean_aggregate_plain(e, i, m))
    assert torch.equal(agg.max_aggregate(e, i, m),
                       agg.max_aggregate_plain(e, i, m))
    assert agg.LAUNCHES == before
    agg.reset_launches()
    assert agg.LAUNCHES == {"gather_mean": 0, "gather_max": 0}


def test_build_targets_hopper_into_the_build_directory():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path.parent.parts[-2:] == ("build", "graphsage_torch")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((got.float() - want.float()).abs() <= 2 * ulp).all()
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mean", "max"])
def test_kernel_matches_plain_on_card(kind, dtype, case):
    dev = _card()
    embed, idx, mask = _case(case)
    e = torch.from_numpy(embed).to(dev, dtype)
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    kernel = agg.mean_aggregate if kind == "mean" else agg.max_aggregate
    plain = (agg.mean_aggregate_plain if kind == "mean"
             else agg.max_aggregate_plain)
    before = agg.LAUNCHES[f"gather_{kind}"]
    got = kernel(e, i, m)
    torch.cuda.synchronize()
    assert agg.LAUNCHES[f"gather_{kind}"] == before + 1
    if kind == "max":
        assert torch.equal(got, plain(e, i, m))
    else:
        _assert_close(got, plain(e, i, m))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_a_strided_view_on_card(dtype):
    """MEAN serving aggregates z[:, H:], rows 2H apart."""
    dev = _card()
    embed, idx, mask = _case("random", seed=1)
    wide = torch.from_numpy(np.concatenate([3 * embed, embed], axis=1))
    view = wide.to(dev, dtype)[:, embed.shape[1]:]
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    got = agg.mean_aggregate(view, i, m)
    assert torch.equal(got, agg.mean_aggregate(view.contiguous(), i, m))
    _assert_close(got, agg.mean_aggregate_plain(view, i, m))


@pytest.mark.gpu
def test_empty_batch_launches_nothing_on_card():
    dev = _card()
    e = torch.randn(5, 8, device=dev)
    i = torch.zeros(0, 3, dtype=torch.int32, device=dev)
    m = torch.zeros(0, 3, device=dev)
    before = dict(agg.LAUNCHES)
    assert agg.mean_aggregate(e, i, m).shape == (0, 8)
    assert agg.LAUNCHES == before


@pytest.mark.gpu
def test_kernel_refuses_autograd_on_card():
    dev = _card()
    embed, idx, mask = _case("random")
    e = torch.from_numpy(embed).to(dev).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        agg.mean_aggregate(e, torch.from_numpy(idx).to(dev),
                           torch.from_numpy(mask).to(dev))
    with torch.no_grad():
        agg.mean_aggregate(e, torch.from_numpy(idx).to(dev),
                           torch.from_numpy(mask).to(dev))
