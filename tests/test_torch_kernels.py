"""The CUDA kernels of graphsage_torch.ops.aggregate, .ops.sddmm and
.ops.gather against their plain versions, and what the kernel wrappers
refuse.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX.  There the ``gpu`` tests run; elsewhere they skip:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerances on the card: float32 rtol=atol=1e-5; bfloat16 within 2 bf16 ulps
(the kernel and the plain version may sum in different orders); MAX exact.
Pair scores in bfloat16: within 2 ulps plus 1e-5, because both versions sum
in float32 in other orders and round once, and near 0, where a dot product
cancels, a float32 difference of ~1e-5 is many bf16 ulps.
Gradients (gather-mean's scatter-add, gather-max's tie-splitting
scatter-add, the score block's analytic backward, the row gather's
scatter-add) against autograd through the plain versions: float32
rtol=atol=1e-5 (float32 scatters are ``index_add_``, atomics in no fixed
order).  bfloat16 scatter-adds (``ops.scatter``) keep JAX's order: equal
bit for bit to the same backward on the CPU.  The row gather is a copy:
equal to ``index_select`` bit for bit.
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch
from test_torch_pretransform import assert_three_piece_bar

from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import build
from graphsage_torch.ops import gather
from graphsage_torch.ops import pretransform as pt
from graphsage_torch.ops import scatter
from graphsage_torch.ops import sddmm

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
    assert torch.equal(gather.gather_rows(e, i[:, 0]),
                       gather.gather_rows_plain(e, i[:, 0]))
    g = e[:idx.shape[0], :8].bfloat16()
    assert torch.equal(scatter.scatter_rows(g, i[:, 0], len(e)),
                       scatter.scatter_rows_plain(g, i[:, 0], len(e)))
    out = agg.max_aggregate(e, i, m)
    gm = torch.ones_like(out)
    assert torch.equal(agg.max_aggregate_backward(gm, e, i, m, out),
                       torch.zeros_like(e).index_add_(
                           0, i.reshape(-1).long(),
                           agg.max_tie_split_plain(gm, e, i, m, out)))
    assert agg.LAUNCHES == before
    agg.reset_launches()
    assert agg.LAUNCHES == {"gather_mean": 0, "gather_max": 0,
                            "gather_max_bwd": 0, "pair_scores": 0,
                            "gather_rows": 0, "scatter_rows": 0,
                            "pretransform": 0}


def _bwd_args(**change):
    args = dict(g=torch.zeros(4, 6), embed=torch.zeros(10, 6),
                idx=torch.zeros(4, 3, dtype=torch.int32),
                mask=torch.ones(4, 3), out=torch.zeros(4, 6))
    args.update(change)
    return args


@pytest.mark.parametrize("args,error,match", [
    (_bwd_args(g=torch.zeros(4, 6, dtype=torch.bfloat16)), TypeError,
     "g must be torch.float32"),
    (_bwd_args(out=torch.zeros(4, 5)), ValueError, "expected out"),
    (_bwd_args(g=torch.zeros(6, 4).T), ValueError, "g must be contiguous"),
    (_bwd_args(idx=torch.zeros(4, 3, dtype=torch.int64)), TypeError, "idx"),
    (_bwd_args(), ValueError, "CUDA device"),
], ids=["g-bf16", "out-shape", "g-transposed", "idx-int64", "cpu-tensors"])
def test_gather_max_bwd_wrapper_refuses_what_the_kernel_does_not_take(
        args, error, match):
    """The tie-split kernel's wrapper raises before any launch: on g and
    out (shape [U, D], the embed dtype, contiguous) and on what
    _check_kernel_args refuses; a CPU tensor is never launched."""
    before = dict(agg.LAUNCHES)
    with pytest.raises(error, match=match):
        agg.gather_max_bwd_kernel(**args)
    assert agg.LAUNCHES == before


def test_build_targets_hopper_into_the_build_directory():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.SOURCES) == {"aggregate", "sddmm", "gather",
                                  "scatter", "pretransform"}
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path.parent.parts[-2:] == ("build", "graphsage_torch")
        assert path.name.startswith(f"libgs_{name}-")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


class _RefusingLock:
    def __enter__(self):
        raise AssertionError("the lock was taken for a loaded library")

    def __exit__(self, *exc):
        return False


def test_loaded_library_is_returned_without_the_lock(monkeypatch):
    loaded = object()
    monkeypatch.setattr(build, "_libs", {"gather": loaded})
    monkeypatch.setattr(build, "_lock", _RefusingLock())
    assert build.load_library("gather") is loaded
    with pytest.raises(AssertionError, match="lock"):
        build.load_library("aggregate")


# ------------------------------------------------------------ launch plans

# (elt, embed address mod 16, row stride bytes, row bytes) -> (unit, lanes,
# units a lane a pass), at the main path's shapes
AGG_PLANS = {
    "serving f32 z[:, H:]": ((4, 0, 1024, 512), (16, 32, 1)),
    "serving bf16 z[:, H:]": ((2, 0, 512, 256), (16, 16, 1)),
    "MAX bf16 layer 1": ((2, 0, 1204, 1204), (4, 32, 4)),
    "MAX bf16 layer 2": ((2, 0, 256, 256), (16, 16, 1)),
    "refresh f32 602": ((4, 0, 2408, 2408), (8, 32, 4)),
    "compact layers": ((4, 0, 512, 512), (16, 32, 1)),
    "offset view": ((4, 4, 2408, 2400), (4, 32, 4)),
    "narrow bf16": ((2, 2, 14, 14), (2, 16, 1)),
    "40 f32": ((4, 0, 160, 160), (16, 16, 1)),
    "130 bf16": ((2, 0, 260, 260), (4, 32, 4)),
    "200 f32": ((4, 0, 800, 800), (16, 32, 2)),
}


@pytest.mark.parametrize("name", sorted(AGG_PLANS))
def test_aggregate_plan_at_the_main_path_shapes(name):
    (elt, mod16, stride, row_bytes), want = AGG_PLANS[name]
    assert agg.aggregate_plan(elt, mod16, stride, row_bytes, 0) == want


@pytest.mark.parametrize("elt", [2, 4])
def test_aggregate_plan_fits_the_kernel(elt):
    """The unit divides every address, stride and width and is the widest
    that does; 16 lanes a row only for rows of at most 16 units; a pass
    covers a row unless the row is wider than 128 units."""
    for d in (1, 3, 7, 16, 33, 128, 130, 600, 602, 1204, 4096):
        for mod16 in range(0, 16, elt):
            for out_mod16 in (0, 8):
                row_bytes = d * elt
                stride = row_bytes + 2 * mod16
                unit, lanes, kc = agg.aggregate_plan(elt, mod16, stride,
                                                     row_bytes, out_mod16)
                counts = (mod16, stride, row_bytes, out_mod16)
                assert unit >= elt and unit in (2, 4, 8, 16)
                assert all(n % unit == 0 for n in counts)
                assert unit == 16 or unit == elt or not all(
                    n % (2 * unit) == 0 for n in counts)
                units = row_bytes // unit
                assert (lanes, kc) == (16, 1) if units <= 16 else lanes == 32
                assert lanes * kc >= units or kc == 4


@pytest.mark.parametrize("elt,counts,want", [
    (4, (0, 512, 512, 0), 16), (4, (0, 2408, 2408, 0), 8),
    (2, (0, 1204, 1204, 0), 4), (2, (2, 14, 14, 0), 2),
    (4, (4, 2408, 2400, 0), 4), (2, (0, 256, 256, 8), 8),
    (4, (0, 0, 0, 0), 16)])
def test_widest_unit(elt, counts, want):
    """The row gather's and the gather-reduce's unit: cached (b)'s 602-wide
    float32 rows take 8 bytes, the microbench's 128-wide rows 16."""
    assert agg.widest_unit(elt, *counts) == want


def test_kernel_ab_needs_a_card():
    """The kernel A/B tool refuses to time anything without a card."""
    if torch.cuda.is_available():
        pytest.skip("with a card the tool would run its timings")
    from graphsage_torch import kernel_ab
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_ab.main(["--baseline", "build/parent"])


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want, bf16_atol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((got.float() - want.float()).abs()
                <= 2 * ulp + bf16_atol).all()
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


def _max_bwd_case(case, seed=4):
    """(embed, idx, mask, g) of the tie-split tests: "ties" duplicates rows
    so that 2 and 3 slots tie (and relu zeros tie everywhere), "hub" sends
    slots 0-6 of every row to row 0, "nonfinite" gives g +inf, -inf and
    NaN (also on a row with every slot masked), "s33" has 33 slots (past
    one 32-bit tie mask) with ties across the 32nd."""
    if case == "hub":
        embed, idx, mask = _hub_case(seed)
    elif case == "s33":
        rng = np.random.RandomState(seed)
        embed = rng.randn(50, 128).astype(np.float32)
        embed[25:] = embed[:25]
        idx = rng.randint(0, 50, (21, 33)).astype(np.int32)
        idx[:, 32] = idx[:, 0] + 25 - 50 * (idx[:, 0] >= 25)
        mask = (rng.rand(21, 33) < 0.8).astype(np.float32)
        mask[:, [0, 32]] = 1.0
    else:
        embed, idx, mask = _case("wide602" if case == "wide602" else
                                 "empty_rows" if case == "empty_rows"
                                 else "random", seed=seed)
    if case == "ties":
        embed[1::3] = embed[0::3][:len(embed[1::3])]
        embed[2::5] = embed[0]
        embed = np.maximum(embed, 0.0)
    g = np.random.RandomState(5).randn(idx.shape[0], embed.shape[1]).astype(
        np.float32)
    if case == "nonfinite":
        g[0, :3] = [np.inf, -np.inf, np.nan]
        mask[1] = 0.0
        g[1, :2] = [np.inf, np.nan]
    return embed, idx, mask, g


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "random", "hub", "nonfinite", "s33",
                                  "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_max_bwd_matches_the_plain_tie_split_on_card(dtype, case):
    """The gather_max_bwd kernel's contributions [U*S, D] equal
    max_tie_split_plain's on CPU copies bit for bit (NaN for NaN), in one
    launch; "strided" reads the embed through a view with rows 2D
    apart."""
    dev = _card()
    embed, idx, mask, g = _max_bwd_case("random" if case == "strided"
                                        else case)
    e = torch.from_numpy(embed).to(dev, dtype)
    if case == "strided":
        e = torch.cat([e, e], dim=1)[:, embed.shape[1]:]
        assert e.stride(0) == 2 * embed.shape[1]
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    gd = torch.from_numpy(g).to(dev, dtype)
    out = agg.max_aggregate(e, i, m)
    before = dict(agg.LAUNCHES)
    got = agg.gather_max_bwd_kernel(gd, e, i, m, out)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["gather_max_bwd"] == before["gather_max_bwd"] + 1
    assert got.shape == (idx.size, embed.shape[1]) and got.dtype == dtype
    want = agg.max_tie_split_plain(gd.cpu(), e.cpu(), i.cpu(), m.cpu(),
                                   out.cpu())
    assert _same_bits(got.cpu(), want)
    assert _same_bits(got, agg.max_tie_split_plain(gd, e, i, m, out))
    if case == "nonfinite":
        assert torch.isnan(got.view(*idx.shape, -1)[1, :, 1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "empty_rows", "wide602", "ties",
                                  "hub", "s33"])
def test_gather_max_backward_on_card(case):
    """max_aggregate's tie-splitting backward on the card (the
    gather_max_bwd kernel, then index_add_) against autograd through the
    plain version (amax over the gather), also through a strided view, and
    against the float64 sum of the plain contributions within the rounding
    bound of a float32 sum: an element of a row with n contributions within
    (n + 1) 2^-24 sum|term|."""
    dev = _card()
    embed, idx, mask, _ = _max_bwd_case(case)
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(5)).to(dev)
    wide = torch.from_numpy(np.concatenate([embed, embed], axis=1)).to(dev)
    d = embed.shape[1]
    before = dict(agg.LAUNCHES)
    grads = []
    for fn in (agg.max_aggregate, agg.max_aggregate_plain):
        w = wide.clone().requires_grad_(True)
        (fn(w[:, d:], i, m) * g).sum().backward()
        grads.append(w.grad)
    # the forward's gather_max and the backward's tie split, no row gather
    assert agg.LAUNCHES["gather_max"] == before["gather_max"] + 1
    assert agg.LAUNCHES["gather_max_bwd"] == before["gather_max_bwd"] + 1
    assert agg.LAUNCHES["gather_rows"] == before["gather_rows"]
    if case != "hub":
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    assert not grads[0][:, :d].any()
    e = wide[:, d:].cpu()
    terms = agg.max_tie_split_plain(g.cpu(), e, i.cpu(), m.cpu(),
                                    agg.max_aggregate_plain(e, i.cpu(),
                                                            m.cpu()))
    flat = i.cpu().reshape(-1).long()
    exact = torch.zeros(e.shape, dtype=torch.float64).index_add_(
        0, flat, terms.double())
    absum = torch.zeros_like(exact).index_add_(0, flat, terms.double().abs())
    n = torch.bincount(flat, minlength=e.shape[0]).double()[:, None]
    for grad in grads:
        assert ((grad[:, d:].double().cpu() - exact).abs()
                <= (n + 1) * 2.0**-24 * absum).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "empty_rows", "many_slots"])
def test_gather_mean_backward_on_card(case):
    """The Function's scatter-add gradient against autograd through the
    plain version, on the card, also through a strided view."""
    dev = _card()
    embed, idx, mask = _case(case, seed=2)
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(3)).to(dev)
    wide = torch.from_numpy(np.concatenate([embed, embed], axis=1)).to(dev)
    before = agg.LAUNCHES["gather_mean"]
    grads = []
    for fn in (agg.mean_aggregate, agg.mean_aggregate_plain):
        w = wide.clone().requires_grad_(True)
        (fn(w[:, embed.shape[1]:], i, m) * g).sum().backward()
        grads.append(w.grad)
    assert agg.LAUNCHES["gather_mean"] == before + 1   # the forward alone
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    assert not grads[0][:, :embed.shape[1]].any()


# ------------------------------------------------------------ pair scores

SCORE_CASES = {
    "ragged": dict(u=1000, h=100, b=3, zero_rows=(0, 17, 999)),
    "tiny_b": dict(u=4096, h=128, b=20, zero_rows=()),
    "one_tile": dict(u=50, h=7, b=1, zero_rows=(4,)),
    "many_targets": dict(u=300, h=33, b=70, zero_rows=(5,)),
    "microbench": dict(u=2048, h=128, b=512, zero_rows=()),
}


def _score_case(name, seed=0):
    c = SCORE_CASES[name]
    rng = np.random.RandomState(seed)
    emb = rng.randn(c["u"], c["h"]).astype(np.float32)
    emb[list(c["zero_rows"])] = 0.0
    t = rng.randint(0, c["u"], c["b"]).astype(np.int32)
    if c["zero_rows"]:
        t[0] = c["zero_rows"][0]      # a target of zero norm
    return emb, t


@pytest.mark.parametrize("args,error,match", [
    (dict(emb=torch.zeros(10, 6), target_rows=torch.zeros(3,
                                                          dtype=torch.int64)),
     TypeError, "target_rows"),
    (dict(emb=torch.zeros(10, 6, dtype=torch.float16),
          target_rows=torch.zeros(3, dtype=torch.int32)), TypeError, "emb"),
    (dict(emb=torch.zeros(6, 10).T,
          target_rows=torch.zeros(3, dtype=torch.int32)), ValueError,
     "column stride"),
    (dict(emb=torch.zeros(10, 6),
          target_rows=torch.zeros(3, 2, dtype=torch.int32)), ValueError,
     "expected"),
    (dict(emb=torch.zeros(10, 6),
          target_rows=torch.zeros(3, dtype=torch.int32)), ValueError,
     "CUDA device"),
], ids=["targets-int64", "emb-f16", "emb-strided-cols", "targets-2d",
        "cpu-tensors"])
def test_score_wrapper_refuses_what_the_kernel_does_not_take(args, error,
                                                             match):
    with pytest.raises(error, match=match):
        sddmm._check_kernel_args(**args)


def test_score_library_builds_beside_the_aggregate_library():
    assert set(build._SIGNATURES["sddmm"]) == {"gs_pair_scores",
                                               "gs_error_string"}
    assert build.library_path("sddmm") != build.library_path("aggregate")


def test_score_entry_point_takes_the_plan():
    """gs_pair_scores takes (dtype, device, emb, emb_stride, target_rows,
    out, B, U, H, eps), then the plan's five ints (tb, tu, unit, hs, vec),
    then the stream."""
    args, restype = build._SIGNATURES["sddmm"]["gs_pair_scores"]
    assert restype is ctypes.c_int
    assert len(args) == 10 + len(sddmm.ScoresPlan._fields) + 1 == 16
    assert args[9] is ctypes.c_float
    assert args[10:15] == [ctypes.c_int] * 5
    assert args[15] is ctypes.c_void_p and args[3] is ctypes.c_int64


# (B, U, H, elt, row stride bytes, address mod 16) -> plan, at the main
# path's shapes
SCORE_PLANS = {
    "compact step 20 x 1024": ((20, 1024, 128, 4, 512, 0),
                               (8, 8, 16, 128, 4)),
    "cached (c) step 20 x 1024": ((20, 1024, 128, 4, 512, 0),
                                  (8, 8, 16, 128, 4)),
    "512 x 2048": ((512, 2048, 128, 4, 512, 0), (64, 64, 16, 128, 4)),
    "ragged 3 x 1000, H 100": ((3, 1000, 100, 4, 400, 0),
                               (8, 8, 16, 104, 4)),
}


@pytest.mark.parametrize("name", sorted(SCORE_PLANS))
def test_scores_plan_at_the_main_path_shapes(name):
    args, want = SCORE_PLANS[name]
    plan = sddmm.scores_plan(*args)
    assert tuple(plan) == want
    b, u = args[:2]
    blocks = math.ceil(u / plan.tu) * math.ceil(b / plan.tb)
    assert blocks >= 125      # up from 16 (compact, ragged) and 64 tiles


@pytest.mark.parametrize("b", [1, 3, 8, 9, 20, 32, 33, 70, 512, 5000])
def test_scores_plan_tiles_fill_the_card_where_u_allows(b):
    """8 x 8 tiles at B <= 32 and 64 x 64 above, the kernel's two tiles;
    at least 132 blocks wherever U gives that many tiles."""
    for u in (1, 7, 100, 1000, 1024, 1056, 2048, 4096, 100_000):
        plan = sddmm.scores_plan(b, u, 128, 4, 512, 0)
        assert (plan.tb, plan.tu) == ((8, 8) if b <= 32 else (64, 64))
        blocks = math.ceil(u / plan.tu) * math.ceil(b / plan.tb)
        if u >= 132 * plan.tu:
            assert blocks >= 132, (u, plan)


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("b", [3, 20, 512])
def test_scores_plan_shared_memory_fits(elt, b):
    """The block's shared memory stays within the two-blocks-an-SM budget
    at every width; a row of at most 256 columns takes one stage where that
    fits, else stages of a multiple of 32 columns, at most 256, whose width
    the copy unit divides."""
    for h in (1, 7, 33, 100, 128, 129, 256, 602, 1000, 2000, 8192):
        plan = sddmm.scores_plan(b, 2048, h, elt, h * elt, 0)
        smem = sddmm.scores_smem(plan.tb, plan.tu, elt, h, plan.hs)
        assert smem <= sddmm.SMEM_BUDGET < 232448 - 8 * plan.tb  # 227 KB
        assert plan.hs % 8 == 0 and (plan.hs * elt) % plan.unit == 0
        assert plan.hs <= sddmm.MAX_STAGE
        one = -(-h // 8) * 8
        if plan.hs >= h:
            assert plan.hs == one                     # one stage
        else:
            assert plan.hs % 32 == 0
            assert one > sddmm.MAX_STAGE or sddmm.scores_smem(
                plan.tb, plan.tu, elt, h, one) > sddmm.SMEM_BUDGET
    # the card tests' wide rows take several stages at every tile
    for b_, u in ((1, 5), (20, 1001), (33, 300), (512, 2048)):
        assert sddmm.scores_plan(b_, u, 2000, elt, 2000 * elt, 0).hs < 2000


@pytest.mark.parametrize("elt,h,stride,mod16,want", [
    (4, 128, 512, 0, 16), (4, 128, 1024, 0, 16),   # compact, z[:, H:] view
    (4, 100, 400, 0, 16), (4, 128, 512, 4, 4),     # offset view
    (4, 33, 132, 0, 4), (4, 602, 2408, 0, 8),
    (2, 128, 256, 0, 16), (2, 128, 256, 2, 2),     # bf16 at odd elements
    (2, 7, 14, 0, 2), (2, 100, 200, 8, 8), (2, 602, 1204, 0, 4)])
def test_scores_plan_copy_unit(elt, h, stride, mod16, want):
    """The copy unit is the widest of 16, 8, 4 (2 for bfloat16) bytes that
    divides the table's address, its row stride and its row width."""
    plan = sddmm.scores_plan(20, 1024, h, elt, stride, mod16)
    assert plan.unit == want
    assert plan.unit >= elt
    assert all(n % plan.unit == 0 for n in (stride, mod16, h * elt))


def test_scores_plan_store_width_and_cache():
    """Four elements a store where U is a multiple of 4; the plan is
    cached, so a launch at a shape seen before costs one lookup."""
    assert sddmm.scores_plan(20, 1000, 128, 4, 512, 0).vec == 4
    assert sddmm.scores_plan(20, 1001, 128, 4, 512, 0).vec == 1
    sddmm.scores_plan.cache_clear()
    sddmm.scores_plan(20, 1024, 128, 4, 512, 0)
    sddmm.scores_plan(20, 1024, 128, 4, 512, 0)
    info = sddmm.scores_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCORE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_kernel_matches_plain_on_card(dtype, case):
    dev = _card()
    emb, t = _score_case(case)
    e = torch.from_numpy(emb).to(dev, dtype)
    tr = torch.from_numpy(t).to(dev)
    before = agg.LAUNCHES["pair_scores"]
    got = sddmm.pair_scores_kernel(e, tr)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["pair_scores"] == before + 1
    _assert_close(got, sddmm.dense_pair_scores(e, tr), bf16_atol=1e-5)
    zero = list(SCORE_CASES[case]["zero_rows"])
    if zero:
        assert not got[:, zero].any() and not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "tiny_b"])
def test_pair_scores_gradient_on_card(case):
    """PairScores (the kernel forward, the analytic backward) against
    autograd through the plain version, on a strided view."""
    dev = _card()
    emb, t = _score_case(case, seed=1)
    tr = torch.from_numpy(t).to(dev)
    g = torch.randn(len(t), emb.shape[0],
                    generator=torch.Generator().manual_seed(4)).to(dev)
    wide = torch.from_numpy(np.concatenate([emb, emb], axis=1)).to(dev)
    h = emb.shape[1]
    outs, grads = [], []
    for fn in (sddmm.pair_scores, sddmm.dense_pair_scores):
        w = wide.clone().requires_grad_(True)
        out = fn(w[:, h:], tr)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append(w.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    assert not grads[0][:, :h].any()


def _scores_input(rng, u, h, b, dev, dtype, offset=0):
    """emb [u, h] (a view at ``offset`` columns into rows of h + 3), with
    zero rows, and b targets, the first of them a zero row."""
    wide = rng.randn(u, h + 3).astype(np.float32)
    zero = sorted({0, u // 2, u - 1})
    wide[zero] = 0.0
    t = rng.randint(0, u, b).astype(np.int32)
    t[0] = zero[-1]
    emb = torch.from_numpy(wide).to(dev, dtype)[:, offset:offset + h]
    return emb, torch.from_numpy(t).to(dev), zero


# H from one column to a row wider than one stage (2000 takes several at
# every tile), B at every target tile, U below one table tile and not a
# multiple of one
SCORE_WIDTHS = [1, 7, 33, 100, 128, 129, 2000]
SCORE_TARGETS = [1, 20, 33, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("b", SCORE_TARGETS)
@pytest.mark.parametrize("h", SCORE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_matches_plain_at_new_shapes_on_card(dtype, h, b):
    dev = _card()
    rng = np.random.RandomState(h * 1000 + b)
    for u in (5, 1001):
        emb, tr, zero = _scores_input(rng, u, h, b, dev, dtype)
        got = sddmm.pair_scores_kernel(emb, tr)
        torch.cuda.synchronize()
        _assert_close(got, sddmm.dense_pair_scores(emb, tr), bf16_atol=1e-5)
        assert not got[:, zero].any() and not got[0].any(), (u, h, b)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [7, 100, 128, 2000])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_takes_strided_views_on_card(dtype, offset, h):
    """Views at element offsets 0-3 into rows of h + 3: every copy unit
    from 16 bytes down to 4 (float32) or 2 (bfloat16)."""
    dev = _card()
    rng = np.random.RandomState(offset * 10 + h)
    for b, u in ((20, 1024), (70, 300)):
        emb, tr, _ = _scores_input(rng, u, h, b, dev, dtype, offset)
        got = sddmm.pair_scores_kernel(emb, tr)
        torch.cuda.synchronize()
        _assert_close(got, sddmm.dense_pair_scores(emb, tr), bf16_atol=1e-5)


@pytest.mark.gpu
def test_pair_scores_refuses_a_plan_that_does_not_fit_on_card():
    """A unit that does not divide the rows (16 bytes on 28-byte rows), 2
    bytes in float32, a tile the kernel does not have, a stage width that is
    not a multiple of 8 or is over 256, four elements a store where U is not
    a multiple of 4, and shared memory past a block's limit (two 256-column
    stages of 192 rows), are refused before any launch."""
    dev = _card()
    emb = torch.randn(10, 7, device=dev)
    t = torch.zeros(3, dtype=torch.int32, device=dev)
    out = torch.empty(3, 10, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load_library("sddmm")

    def call(tb=8, tu=8, unit=4, hs=8, vec=1, h=7, e=emb):
        return lib.gs_pair_scores(0, dev.index or 0, e.data_ptr(),
                                  e.stride(0), t.data_ptr(), out.data_ptr(),
                                  3, 10, h, 1e-8, tb, tu, unit, hs, vec,
                                  stream)

    assert call() == 0
    wide = torch.randn(10, 20000, device=dev)
    for bad in (dict(unit=16), dict(unit=2), dict(tb=12), dict(tu=32),
                dict(hs=12), dict(hs=0), dict(hs=264), dict(vec=4),
                dict(vec=2), dict(tb=64, tu=128, hs=256, h=20000, e=wide)):
        assert call(**bad) != 0, bad
    torch.cuda.synchronize()


# ------------------------------------------------------------ row gather

@pytest.mark.parametrize("args,error,match", [
    (dict(table=torch.zeros(10, 6), idx=torch.zeros(3, dtype=torch.int64)),
     TypeError, "idx"),
    (dict(table=torch.zeros(10, 6, dtype=torch.float16),
          idx=torch.zeros(3, dtype=torch.int32)), TypeError, "table"),
    (dict(table=torch.zeros(6, 10).T, idx=torch.zeros(3, dtype=torch.int32)),
     ValueError, "column stride"),
    (dict(table=torch.zeros(10, 6),
          idx=torch.zeros(3, 2, dtype=torch.int32)), ValueError, "expected"),
    (dict(table=torch.zeros(10, 6),
          idx=torch.zeros(6, dtype=torch.int32)[::2]), ValueError,
     "contiguous"),
    (dict(table=torch.zeros(10, 6), idx=torch.zeros(3, dtype=torch.int32)),
     ValueError, "CUDA device"),
], ids=["idx-int64", "table-f16", "table-strided-cols", "idx-2d",
        "idx-strided", "cpu-tensors"])
def test_gather_wrapper_refuses_what_the_kernel_does_not_take(args, error,
                                                              match):
    with pytest.raises(error, match=match):
        gather._check_kernel_args(**args)


def test_gather_library_builds_beside_the_others():
    assert set(build._SIGNATURES["gather"]) == {"gs_gather_rows",
                                                "gs_error_string"}
    assert build.library_path("gather") not in {
        build.library_path("aggregate"), build.library_path("sddmm")}


GATHER_CASES = {
    "microbench": dict(m=1000, d=128, j=4096),
    "features602": dict(m=500, d=602, j=700),     # 8-byte-aligned rows
    "unaligned": dict(m=50, d=7, j=33),           # odd width
    "one_row": dict(m=1, d=130, j=5),
}


def _gather_case(name, seed=0):
    c = GATHER_CASES[name]
    rng = np.random.RandomState(seed)
    table = rng.randn(c["m"], c["d"]).astype(np.float32)
    return table, rng.randint(0, c["m"], c["j"]).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_equals_index_select_on_card(dtype, case):
    dev = _card()
    table, idx = _gather_case(case)
    t = torch.from_numpy(table).to(dev, dtype)
    i = torch.from_numpy(idx).to(dev)
    before = agg.LAUNCHES["gather_rows"]
    got = gather.gather_rows(t, i)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(got, t.index_select(0, i.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_gather_rows_takes_strided_views_on_card(dtype, offset):
    """Views whose address and row stride take every load width: a
    [:, offset:offset + D] window of a wider table."""
    dev = _card()
    table, idx = _gather_case("unaligned", seed=1)
    wide = torch.from_numpy(np.concatenate([table] * 3, axis=1)).to(dev,
                                                                    dtype)
    view = wide[:, offset:offset + 16]
    i = torch.from_numpy(idx).to(dev)
    assert torch.equal(gather.gather_rows(view, i),
                       view.index_select(0, i.long()))


NEW_GATHER_WIDTHS = [1, 7, 128, 130, 602, 1204]


@pytest.mark.gpu
@pytest.mark.parametrize("d", NEW_GATHER_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_bit_equal_at_every_offset_on_card(dtype, offset, d):
    """Table views at element offsets 0-3 (every 16-byte alignment of the
    source rows against the output rows), J from one id to more than one
    wave of blocks."""
    dev = _card()
    rng = np.random.RandomState(d + offset)
    m = 3000
    wide = torch.from_numpy(rng.randn(m, d + 3).astype(np.float32)).to(
        dev, dtype)
    view = wide[:, offset:offset + d]
    # narrow rows pack many rows a warp: a million ids is over one wave
    for j in (1, 33, 40_000) + ((1_000_000,) if d < 128 else ()):
        i = torch.from_numpy(rng.randint(0, m, j).astype(np.int32)).to(dev)
        got = gather.gather_rows_kernel(view, i)
        torch.cuda.synchronize()
        assert torch.equal(got, view.index_select(0, i.long())), (j, d)


@pytest.mark.gpu
def test_kernels_refuse_a_plan_that_does_not_fit_on_card():
    """A unit that does not divide the rows (2408-byte rows at 16), is not
    a unit (3, 32) or is narrower than an element (2 in float32), and for
    the gather-reduce 16 lanes on a row of more than 16 units or an unknown
    units-a-pass, are refused before any launch."""
    dev = _card()
    t = torch.randn(10, 602, device=dev)
    i = torch.zeros(4, dtype=torch.int32, device=dev)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    mask = torch.ones(4, 3, device=dev)
    out = torch.empty(4, 602, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = build.load_library("gather")
    for unit in (16, 3, 32, 2):
        assert rows.gs_gather_rows(0, dev.index or 0, t.data_ptr(), 602,
                                   i.data_ptr(), out.data_ptr(), 4, 602,
                                   unit, stream) != 0
    reduce = build.load_library("aggregate")
    for unit, lanes, kc in ((16, 32, 4), (2, 32, 4), (8, 16, 1), (8, 32, 3),
                            (8, 8, 1)):
        for fn in (reduce.gs_gather_mean, reduce.gs_gather_max):
            assert fn(0, dev.index or 0, t.data_ptr(), 602, idx.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), 4, 3, 602, unit,
                      lanes, kc, stream) != 0
    torch.cuda.synchronize()


REDUCE_WIDTHS = [128, 130, 600, 602, 1204]
REDUCE_SLOTS = [1, 10, 11, 32, 45]


@pytest.mark.gpu
@pytest.mark.parametrize("s", REDUCE_SLOTS)
@pytest.mark.parametrize("d", REDUCE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mean", "max"])
def test_gather_reduce_matches_plain_at_new_shapes_on_card(kind, dtype, d,
                                                           s):
    """Widths that take 16-, 8-, 4- and 2-byte units, slot counts on both
    sides of a slot group, U from one row to fewer blocks than SMs."""
    dev = _card()
    rng = np.random.RandomState(d * 100 + s)
    m = 700
    e = torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(dev, dtype)
    kernel = agg.mean_aggregate if kind == "mean" else agg.max_aggregate
    plain = (agg.mean_aggregate_plain if kind == "mean"
             else agg.max_aggregate_plain)
    for u in (1, 37, 131, 1000):
        i = torch.from_numpy(rng.randint(0, m, (u, s)).astype(np.int32)).to(
            dev)
        msk = torch.from_numpy((rng.rand(u, s) < 0.7).astype(np.float32)).to(
            dev)
        got = kernel(e, i, msk)
        torch.cuda.synchronize()
        if kind == "max":
            assert torch.equal(got, plain(e, i, msk)), u
        else:
            _assert_close(got, plain(e, i, msk))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mean", "max"])
def test_masked_slot_rows_never_reach_the_output_on_card(kind, dtype):
    """Rows holding inf and nan, referenced only by masked slots: the
    kernel reads no row for a masked slot, so the output equals the plain
    version on a table with those rows zeroed."""
    dev = _card()
    rng = np.random.RandomState(9)
    m, u, s, d = 60, 50, 11, 602
    embed = rng.randn(m, d).astype(np.float32)
    idx = rng.randint(0, m, (u, s)).astype(np.int32)
    mask = (rng.rand(u, s) < 0.7).astype(np.float32)
    bad = [3, 17, 41]
    idx[:, 4] = bad[0]
    mask[:, 4] = 0.0
    idx[np.isin(idx, bad) & (mask > 0)] = 0
    idx[::3, 7] = bad[1]
    mask[::3, 7] = 0.0
    idx[1, :] = bad[2]
    mask[1, :] = 0.0                              # a row with no valid slot
    poisoned = embed.copy()
    poisoned[bad[0]] = np.inf
    poisoned[bad[1]] = np.nan
    poisoned[bad[2], ::2] = -np.inf
    clean = embed.copy()
    clean[bad] = 0.0
    i, msk = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    kernel = agg.mean_aggregate if kind == "mean" else agg.max_aggregate
    plain = (agg.mean_aggregate_plain if kind == "mean"
             else agg.max_aggregate_plain)
    got = kernel(torch.from_numpy(poisoned).to(dev, dtype), i, msk)
    want = plain(torch.from_numpy(clean).to(dev, dtype), i, msk)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[1].any()
    if kind == "max":
        assert torch.equal(got, want)
    else:
        _assert_close(got, want)


@pytest.mark.gpu
def test_gather_rows_empty_idx_launches_nothing_on_card():
    dev = _card()
    t = torch.randn(5, 8, device=dev)
    before = dict(agg.LAUNCHES)
    out = gather.gather_rows(t, torch.zeros(0, dtype=torch.int32,
                                            device=dev))
    assert out.shape == (0, 8)
    assert agg.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["microbench", "features602"])
def test_gather_rows_backward_on_card(case):
    """GatherRows' index_add_ gradient against autograd through
    index_select, on a strided view."""
    dev = _card()
    table, idx = _gather_case(case, seed=2)
    i = torch.from_numpy(idx).to(dev)
    g = torch.randn(len(idx), table.shape[1],
                    generator=torch.Generator().manual_seed(3)).to(dev)
    wide = torch.from_numpy(np.concatenate([table, table], axis=1)).to(dev)
    d = table.shape[1]
    grads = []
    for fn in (gather.gather_rows, gather.gather_rows_plain):
        w = wide.clone().requires_grad_(True)
        (fn(w[:, d:], i) * g).sum().backward()
        grads.append(w.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    assert not grads[0][:, :d].any()


# ------------------------------------------------------------ scatter

SCATTER_CASES = {
    "random": dict(m=53, d=19, j=400),            # odd width: 16-bit lanes
    "hub128": dict(m=300, d=128, j=6000),         # 3,000 into row 0
    "features602": dict(m=500, d=602, j=700),
    "zero_rows": dict(m=40, d=64, j=2000),        # +-0 contributions
    "no_rows": dict(m=30, d=8, j=0),
    "one_col": dict(m=7, d=1, j=90),
    # rows of more than 256 contributions take a block each
    "long602": dict(m=50, d=602, j=3000),         # 1,000 into row 0
    "long_odd": dict(m=20, d=33, j=2000),         # 667 into row 5
    "many_long": dict(m=300, d=64, j=78000),      # more rows than blocks
    # the counting sort's passes
    "descending": dict(m=300, d=128, j=6000),     # ids in descending order
    "k_long_edge": dict(m=20, d=128, j=1200),     # rows of K_LONG, + 1
    "nonfinite": dict(m=40, d=64, j=3000),        # NaN and +-inf terms
    "all_zero": dict(m=30, d=128, j=2000),        # every term +-0
    "one_row": dict(m=1, d=20, j=700),            # M = 1, 40-byte rows
    "sparse": dict(m=100_000, d=8, j=300),        # long untouched runs
    "width72": dict(m=50, d=72, j=1500),          # 9 of 16 lanes a row
    # row 0 spread over more place blocks than a long block's sort window
    # holds (scatter.LONG_SMEM / 8 blocks), at the narrowest width: sorted
    # in two windows
    "over_window": dict(m=64, d=1, j=scatter.LONG_SMEM // 8
                        * scatter.PLACE_BLOCK + 4096),
}
# over_window's 1,576,960 terms take the sequential loop about 20 s on the
# CPU: it is held against the plain version on the card only, and against
# the JAX package's VJP scatter in tests/test_torch_bf16.py
CPU_SCATTER_CASES = sorted(set(SCATTER_CASES) - {"over_window"})


def _scatter_rows_case(name, seed=0):
    c = SCATTER_CASES[name]
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(c["j"], c["d"]).astype(np.float32)
                         ).bfloat16()
    idx = rng.randint(0, c["m"], c["j"]).astype(np.int32)
    if name == "hub128":
        idx[::2] = 0
    if name == "long602":
        idx[:1000] = 0
        idx[1000:1400] = 1
    if name == "long_odd":
        idx[::3] = 5
    if name == "zero_rows":
        idx[:1000] = 3
        g[::3] = 0.0
        g[1::3] = -0.0
    if name == "descending":                      # hubs at rows 0 and 1
        idx[::3] = 0
        idx[1::5] = 1
        idx = np.sort(idx)[::-1].copy()
    if name == "k_long_edge":                     # nothing else in 0 and 1
        idx = rng.randint(2, c["m"], c["j"]).astype(np.int32)
        pick = rng.permutation(c["j"])
        k = scatter.K_LONG
        idx[pick[:k]] = 0
        idx[pick[k:2 * k + 1]] = 1
    if name == "nonfinite":
        idx[::4] = 7                              # a long row of 750
        g[8, 5] = float("nan")                    # row 7 turns NaN
        g[100, :3] = float("inf")
        g[200, 1:4] = float("-inf")               # inf + -inf: NaN
        g[301, 10] = float("inf")
        g[[302, 303, 305], 11] = float("-inf")
    if name == "all_zero":
        g = torch.zeros_like(g)
        g[::2] = -0.0
    if name == "sparse":                          # rows 7, 20007, ...
        idx = (rng.randint(0, 5, c["j"]) * 20_000 + 7).astype(np.int32)
    if name == "over_window":                     # mostly zero terms
        g[rng.rand(c["j"]) < 0.995] = 0.0
        idx[::1024] = 0
        g[::1024] = 1.0 + torch.from_numpy(
            rng.rand(len(idx[::1024]), 1).astype(np.float32)).bfloat16()
    return g, torch.from_numpy(idx), c["m"]


def _same_bits(got, want):
    """Bit for bit, except that any NaN matches any NaN: the NaN a bfloat16
    add returns is the device's (a float32 NaN rounded on the CPU, the
    card's canonical NaN), as is the NaN of inf * 0."""
    nan = torch.isnan(got)
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(nan, torch.isnan(want))
            and torch.equal(got.view(ints)[~nan], want.view(ints)[~nan]))


@pytest.mark.parametrize("case", CPU_SCATTER_CASES)
def test_scatter_rows_plain_adds_in_index_order(case):
    """The plain version equals the loop that adds each contribution in
    index order, each add rounded to bfloat16, bit for bit (signs of zero
    included: an untouched or all-zero row is +0)."""
    g, idx, m = _scatter_rows_case(case)
    got = scatter.scatter_rows_plain(g, idx, m)
    want = _sequential_scatter(g, idx, m)
    assert _same_bits(got, want)
    assert not torch.signbit(got[got == 0]).any()


def test_scatter_rows_keeps_float32_on_index_add():
    g = torch.randn(50, 6)
    idx = torch.randint(0, 9, (50,),
                        generator=torch.Generator().manual_seed(1))
    want = torch.zeros(9, 6).index_add_(0, idx, g)
    assert torch.equal(scatter.scatter_rows(g, idx.int(), 9), want)


@pytest.mark.parametrize("args,error,match", [
    (dict(g=torch.zeros(4, 3), idx=torch.zeros(4, dtype=torch.int32)),
     TypeError, "bfloat16"),
    (dict(g=torch.zeros(4, 3, dtype=torch.bfloat16),
          idx=torch.zeros(4, dtype=torch.int64)), TypeError, "idx"),
    (dict(g=torch.zeros(3, 4, dtype=torch.bfloat16).T,
          idx=torch.zeros(4, dtype=torch.int32)), ValueError, "contiguous"),
    (dict(g=torch.zeros(4, 3, dtype=torch.bfloat16),
          idx=torch.zeros(5, dtype=torch.int32)), ValueError, "expected"),
    (dict(g=torch.zeros(4, 3, dtype=torch.bfloat16),
          idx=torch.zeros(4, dtype=torch.int32)), ValueError, "CUDA device"),
], ids=["g-f32", "idx-int64", "g-strided", "idx-length", "cpu-tensors"])
def test_scatter_wrapper_refuses_what_the_kernel_does_not_take(args, error,
                                                               match):
    with pytest.raises(error, match=match):
        scatter._check_kernel_args(num_rows=10, **args)


def test_scatter_library_builds_beside_the_others():
    assert set(build._SIGNATURES["scatter"]) == {
        "gs_scatter_rows", "gs_scatter_scratch", "gs_scatter_add_latency",
        "gs_error_string"}
    args, restype = build._SIGNATURES["scatter"]["gs_scatter_rows"]
    assert len(args) == 16 and restype is ctypes.c_int


def _scatter_source_constant(name):
    """The value of ``constexpr int name = ...;`` in csrc/scatter.cu: a sum
    of products of integers and of the file's other such constants."""
    src = build.SOURCES["scatter"].read_text()
    match = re.search(rf"constexpr int {name} = ([0-9A-Za-z_ *+]+);", src)
    assert match, name

    def factor(f):
        f = f.strip()
        return int(f) if f.isdigit() else _scatter_source_constant(f)

    return sum(math.prod(factor(f) for f in term.split("*"))
               for term in match.group(1).split("+"))


def test_scatter_plan_limits_mirror_the_source():
    """The limits ops/scatter.py plans against are the ones gs_scatter_rows
    checks."""
    assert scatter.MAX_K_LONG == _scatter_source_constant("kMaxLong")
    assert scatter.SLOT_ROWS == _scatter_source_constant("kSlotRows")
    assert scatter.MAX_SLOTS == _scatter_source_constant("kMaxSlots")
    assert scatter.MAX_LONG_SMEM == _scatter_source_constant("kMaxSmem")
    assert scatter.HEADER == _scatter_source_constant("kHeader")
    assert scatter.PLACE_BLOCK == _scatter_source_constant("kPlace")


PLAN_SHAPES = [  # (j, d, m, g_mod16, out_mod16)
    (720_896, 128, 100_000, 0, 0), (495_616, 128, 100_000, 0, 0),
    (360_448, 128, 100_000, 0, 0), (90_112, 128, 32_768, 0, 0),
    (11_264, 128, 8192, 0, 0), (45_056, 128, 45_056, 0, 0),
    (400, 19, 53, 0, 0), (700, 602, 500, 0, 0), (2000, 33, 20, 0, 0),
    (78_000, 64, 300, 0, 0), (6000, 128, 300, 2, 0), (6000, 128, 300, 8, 8),
    (500, 72, 9, 0, 0), (500, 136, 9, 0, 0), (90, 1, 7, 0, 0),
    (0, 8, 30, 0, 0), (700, 20, 1, 0, 0), (300, 8, 100_000, 0, 0),
    (10**8, 128, 10**6, 0, 4)]


@pytest.mark.parametrize("j,d,m,g_mod16,out_mod16", PLAN_SHAPES)
def test_scatter_plan_fits_the_kernel(j, d, m, g_mod16, out_mod16):
    """The plan's unit, group, vector width, long threshold, long blocks,
    ring and scratch against what gs_scatter_rows takes."""
    plan = scatter.scatter_plan(j, d, m, g_mod16, out_mod16)
    assert plan.unit in (2, 4, 8, 16)
    assert (2 * d) % plan.unit == 0 and g_mod16 % plan.unit == 0
    units = 2 * d // plan.unit
    assert plan.group == min(32, 1 << max(0, (units - 1).bit_length()))
    assert plan.vec in (1, 2, 4, 8) and d % plan.vec == 0
    assert g_mod16 % (2 * plan.vec) == 0 and out_mod16 % (2 * plan.vec) == 0
    if plan.vec == 8:                               # 16 lanes a row
        assert 64 < d <= 128
        assert 1 <= plan.k_long <= scatter.MAX_K_LONG // 2
    else:
        assert plan.vec == 1 or 32 * plan.vec <= d  # no idle lanes
        assert 1 <= plan.k_long <= scatter.MAX_K_LONG
    assert 1 <= plan.long_blocks <= max(1, j // (plan.k_long + 1))
    assert plan.long_blocks <= 65536
    slot = scatter.SLOT_ROWS * 32 * min(plan.vec, 2) * 2
    assert plan.long_smem % 16 == 0
    assert plan.long_smem <= scatter.MAX_LONG_SMEM
    assert 2 <= plan.long_smem // slot <= scatter.MAX_SLOTS
    assert plan.scratch == scatter.scratch_ints(j, m, plan.k_long) == (
        scatter.HEADER + 3 * m + j // (plan.k_long + 1) + 4 * j)


def test_scatter_plan_at_the_main_path_width():
    """Width 128 at 16-byte addresses: 16-byte count loads, 16 lanes a row
    (two rows a warp), in the sum pass 16 lanes of 8 columns a short row
    (two rows a warp, four bf16x2 chains), rows of more than 64 to a block,
    four 49,152-byte blocks a multiprocessor."""
    plan = scatter.scatter_plan(720_896, 128, 100_000, 0, 0)
    assert plan[:5] == (16, 16, 8, 64, 264)
    assert plan.long_smem == 49_152
    assert scatter.scatter_plan(11_264, 128, 8192, 0, 0).long_blocks == 173


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_rows_kernel_equals_plain_on_card(case):
    """The kernel against the plain version on the card and on the CPU,
    bit for bit (a NaN matches a NaN); one launch."""
    dev = _card()
    g, idx, m = _scatter_rows_case(case, seed=1)
    before = agg.LAUNCHES["scatter_rows"]
    got = scatter.scatter_rows(g.to(dev), idx.to(dev), m)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["scatter_rows"] == before + 1
    assert _same_bits(got, scatter.scatter_rows_plain(g.to(dev), idx.to(dev),
                                                      m))
    assert _same_bits(got.cpu(), scatter.scatter_rows_plain(g, idx, m))


@pytest.mark.gpu
def test_scatter_rows_kernel_takes_an_odd_address_on_card():
    """An output gradient that starts 2 bytes into its buffer takes the
    16-bit lanes."""
    dev = _card()
    g, idx, m = _scatter_rows_case("hub128", seed=2)
    buf = torch.zeros(g.numel() + 1, dtype=torch.bfloat16, device=dev)
    view = buf[1:].view(g.shape)
    view.copy_(g.to(dev))
    assert view.data_ptr() % 4 == 2
    got = scatter.scatter_rows_kernel(view, idx.to(dev), m)
    assert torch.equal(got.cpu(), scatter.scatter_rows_plain(g, idx, m))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub128", "descending", "long602",
                                  "long_odd", "nonfinite", "one_row",
                                  "width72", "over_window"])
@pytest.mark.parametrize("k_long,long_smem", [
    (1, None), (32, None), (33, None), (100, None), (256, "smallest")])
def test_scatter_rows_other_plans_on_card(case, k_long, long_smem):
    """Other plans than scatter_plan's: a long threshold of 1 (every row of
    two or more takes a block), 32, 33, 100 and 256 (128 where a row takes
    16 lanes, the most they sort), and the smallest ring (two
    slots), whose sort window (1,024 place blocks at one column a lane,
    2,048 at two or more) sorts over_window's long row in 7 windows: all
    equal to the plain version."""
    dev = _card()
    g, idx, m = _scatter_rows_case(case, seed=3)
    g, idx = g.to(dev), idx.to(dev)
    j, d = g.shape
    plan = scatter.scatter_plan(j, d, m, g.data_ptr() % 16, 0)
    if plan.vec == 8:
        k_long = min(k_long, scatter.MAX_K_LONG // 2)
    smem = (plan.long_smem if long_smem is None
            else 2 * scatter.SLOT_ROWS * 32 * min(plan.vec, 2) * 2)
    plan = plan._replace(k_long=k_long, long_smem=smem,
                         long_blocks=max(1, min(j // (k_long + 1), 264)),
                         scratch=scatter.scratch_ints(j, m, k_long))
    got = scatter.scatter_rows_kernel(g, idx, m, plan=plan)
    assert _same_bits(got, scatter.scatter_rows_plain(g, idx, m))


@pytest.mark.gpu
def test_scatter_refuses_a_plan_that_does_not_fit_on_card():
    """Each field of the plan outside what the kernel takes, and a scratch
    one int32 short, is refused before any launch."""
    dev = _card()
    j, d, m = 600, 128, 40
    g = torch.ones(j, d, dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(j, dtype=torch.int32, device=dev)
    out = torch.empty(m, d, dtype=torch.bfloat16, device=dev)
    plan = scatter.scatter_plan(j, d, m, g.data_ptr() % 16,
                                out.data_ptr() % 16)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=dev)
    lib = build.load_library("scatter")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(p, ints=None):
        return lib.gs_scatter_rows(
            dev.index or 0, g.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
            p.scratch if ints is None else ints, out.data_ptr(), j, d, m,
            p.unit, p.group, p.vec, p.k_long, p.long_blocks, p.long_smem,
            stream)

    assert call(plan) == 0
    assert plan.vec == 8                         # 16 lanes a row
    for change in (dict(unit=3), dict(unit=32), dict(group=8),
                   dict(group=32), dict(vec=16), dict(vec=3), dict(k_long=0),
                   dict(k_long=129), dict(k_long=257), dict(long_blocks=0),
                   dict(long_smem=plan.long_smem + 8),
                   dict(long_smem=4096), dict(long_smem=300 * 1024)):
        assert call(plan._replace(**change)) != 0, change
    assert call(plan, ints=plan.scratch - 1) != 0
    torch.cuda.synchronize()
    want = scatter.scatter_rows_plain(g, idx, m)
    assert torch.equal(out, want)                # the one accepted call


@pytest.mark.gpu
def test_scatter_scratch_and_add_latency_on_card():
    """The library's scratch size is the plan's; its latency helper times
    a chain of bf16x2 adds of 1.0 from 0, which stops at 256 (256 + 1
    rounds back to 256, ties to even)."""
    dev = _card()
    lib = build.load_library("scatter")
    for j, m, k_long in ((0, 1, 256), (720_896, 100_000, 256),
                         (1000, 3, 1), (10**8, 10**6, 100)):
        assert lib.gs_scatter_scratch(j, m, k_long) == scatter.scratch_ints(
            j, m, k_long)
    one = torch.ones(2, dtype=torch.bfloat16).view(torch.int32).item()
    inp = torch.tensor([0, one], dtype=torch.int64).to(torch.int32).to(dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert lib.gs_scatter_add_latency(dev.index or 0, inp.data_ptr(),
                                      out.data_ptr(), 4096, stream) == 0
    torch.cuda.synchronize()
    cycles, ns, bits = out.tolist()
    assert cycles > 4096 and ns > 0
    want = torch.full((2,), 256.0, dtype=torch.bfloat16).view(torch.int32)
    assert bits & 0xffffffff == want.item() & 0xffffffff


# ------------------------------------------------------------ bf16 backwards
#
# A bfloat16 backward rounds each contribution to bfloat16 and adds a row's
# contributions one at a time in index order, each add rounded to bfloat16
# (ops/scatter.py: JAX's order; tests/test_torch_bf16.py holds it against
# the JAX package bit for bit).  The scatter_rows kernel keeps that order,
# so each bfloat16 backward on the card equals the same backward on the
# CPU (the plain versions) bit for bit, hub rows included, where a row of
# thousands of contributions stagnates far from its float64 sum (printed).

HUB = dict(u=1500, s=11, m=300, d=64)


def _hub_case(seed=0):
    """Slots 0-6 of every row point at row 0: with the mask's 70%, row 0
    takes about 7,350 contributions."""
    rng = np.random.RandomState(seed)
    embed = rng.randn(HUB["m"], HUB["d"]).astype(np.float32)
    idx = rng.randint(0, HUB["m"], (HUB["u"], HUB["s"])).astype(np.int32)
    idx[:, :7] = 0
    mask = (rng.rand(HUB["u"], HUB["s"]) < 0.7).astype(np.float32)
    return embed, idx, mask


def _scatter_case(case, seed):
    return _hub_case(seed) if case == "hub" else _case(case, seed=seed)


def _sequential_scatter(terms, idx, m):
    """The bfloat16 scatter as a loop over the contributions in index
    order, each add rounded to bfloat16."""
    out = torch.zeros(m, terms.shape[1], dtype=torch.bfloat16)
    for j, r in enumerate(idx.reshape(-1).tolist()):
        out[r] = out[r] + terms[j]
    return out


def _report(what, grad, idx, terms, m):
    """The largest deviation of ``grad`` from the float64 sum of ``terms``,
    relative to that sum's largest magnitude, at the row with the most
    nonzero contributions; returns that row's contribution count."""
    idx = idx.reshape(-1).long().cpu()
    terms = terms.double().cpu()
    exact = torch.zeros(m, terms.shape[1], dtype=torch.float64)
    exact.index_add_(0, idx, terms)
    counts = torch.bincount(idx[(terms != 0).any(dim=1)], minlength=m)
    hub = int(counts.argmax())
    dev = float((grad.double().cpu()[hub] - exact[hub]).abs().max()
                / exact[hub].abs().max().clamp_min(1e-30))
    print(f"{what}: row {hub}, {int(counts[hub])} nonzero contributions, "
          f"lies {dev:.3e} of its largest |sum| from the float64 sum")
    return int(counts[hub])


def _mean_terms(g, mask):
    """The bfloat16 contributions of the masked mean's backward, [U*S, D]:
    slot s of row u adds g[u] * bf16(mask[u, s] / max(sum mask[u], 1))."""
    w = (mask / mask.sum(1, keepdim=True).clamp_min(1.0)).to(g.dtype)
    return (g[:, None, :] * w[:, :, None]).reshape(-1, g.shape[1])


def _max_terms(g, embed, idx, mask):
    """The bfloat16 contributions of the masked max's backward, [U*S, D]:
    g split equally among the valid slots equal to the output."""
    out = agg.max_aggregate_plain(embed, idx, mask)
    is_max = ((embed[idx.long()] == out[:, None, :])
              & (mask[..., None] > 0)).to(g.dtype)
    denom = is_max.sum(1, keepdim=True).clamp_min(1.0)
    return (g[:, None, :] * is_max / denom).reshape(-1, g.shape[1])


def _bf16_grad(fn, embed, loss_of):
    leaf = embed.clone().requires_grad_(True)
    loss_of(fn, leaf).backward()
    return leaf.grad


def _card_and_cpu(fn, embed, args, g):
    """The bfloat16 gradient of sum(fn(embed, *args) * g) on the card (the
    kernels) and from CPU copies of the same inputs (the plain versions);
    the card's run launches scatter_rows once."""
    grads = []
    for dev in (embed.device, torch.device("cpu")):
        before = agg.LAUNCHES["scatter_rows"]
        grads.append(_bf16_grad(
            fn, embed.to(dev), lambda f, leaf: (f(leaf, *(
                a.to(dev) for a in args)).float() * g.to(dev).float()
            ).sum()))
        assert agg.LAUNCHES["scatter_rows"] == before + int(dev.type
                                                            == "cuda")
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0].cpu(), grads[1])
    return grads[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "empty_rows", "many_slots",
                                  "hub"])
def test_gather_mean_backward_bf16_on_card(case):
    dev = _card()
    embed, idx, mask = _scatter_case(case, seed=2)
    e = torch.from_numpy(embed).to(dev, torch.bfloat16)
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(3)).to(
                        dev, torch.bfloat16)
    grad = _card_and_cpu(agg.mean_aggregate, e, (i, m), g)
    n = _report(f"gather_mean bf16 backward {case}", grad, i,
                _mean_terms(g, m), e.shape[0])
    assert case != "hub" or n >= 1000


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "random", "hub", "s33"])
def test_gather_max_backward_bf16_on_card(case):
    """The whole bfloat16 backward (gather_max_bwd, then scatter_rows)
    equals the CPU composition bit for bit; cases of _max_bwd_case."""
    dev = _card()
    embed, idx, mask, _ = _max_bwd_case(case)
    e = torch.from_numpy(embed).to(dev, torch.bfloat16)
    i, m = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(5)).to(
                        dev, torch.bfloat16)
    before = dict(agg.LAUNCHES)
    grad = _card_and_cpu(agg.max_aggregate, e, (i, m), g)
    assert agg.LAUNCHES["gather_max_bwd"] == before["gather_max_bwd"] + 1
    assert agg.LAUNCHES["gather_rows"] == before["gather_rows"]
    n = _report(f"gather_max bf16 backward {case}", grad, i,
                _max_terms(g, e, i, m), e.shape[0])
    assert case != "hub" or n >= 1000


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["microbench", "features602", "hub"])
def test_gather_rows_backward_bf16_on_card(case):
    dev = _card()
    if case == "hub":
        rng = np.random.RandomState(6)
        table = rng.randn(300, 128).astype(np.float32)
        idx = rng.randint(0, 300, 4000).astype(np.int32)
        idx[:1500] = 0
    else:
        table, idx = _gather_case(case, seed=2)
    t = torch.from_numpy(table).to(dev, torch.bfloat16)
    i = torch.from_numpy(idx).to(dev)
    g = torch.randn(len(idx), table.shape[1],
                    generator=torch.Generator().manual_seed(3)).to(
                        dev, torch.bfloat16)
    grad = _card_and_cpu(gather.gather_rows, t, (i,), g)
    n = _report(f"gather_rows bf16 backward {case}", grad, i, g,
                t.shape[0])
    assert case != "hub" or n >= 1000


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "tiny_b"])
def test_pair_scores_gradient_bf16_on_card(case):
    """PairScores' analytic backward in bf16 against autograd through the
    plain version: both compute in float32 and round once, so within 2
    bf16 ulps plus 1e-5 of the gradient's largest magnitude (cancelling
    sums near 0)."""
    dev = _card()
    emb, t = _score_case(case, seed=1)
    e = torch.from_numpy(emb).to(dev, torch.bfloat16)
    tr = torch.from_numpy(t).to(dev)
    g = torch.randn(len(t), emb.shape[0],
                    generator=torch.Generator().manual_seed(4)).to(
                        dev, torch.bfloat16)
    grads = [_bf16_grad(fn, e, lambda f, leaf: (f(leaf, tr).float()
                                                 * g.float()).sum())
             for fn in (sddmm.pair_scores, sddmm.dense_pair_scores)]
    assert grads[0].dtype == torch.bfloat16
    _assert_close(grads[0], grads[1],
                  bf16_atol=1e-5 * float(grads[1].float().abs().max()))


@pytest.mark.parametrize("kind", ["mean", "max", "rows"])
def test_bf16_backward_within_the_rounding_bound_on_the_cpu(kind):
    """The CPU's bfloat16 backwards (the Functions' plain versions) on the
    hub case equal the contributions added in index order in bfloat16,
    row by row (a loop), so they keep to the rounding bound of such a sum:
    an element of a row with n contributions within (n + 1) 2^-8 sum|term|
    of the float64 sum."""
    embed, idx, mask = _hub_case(seed=7)
    e = torch.from_numpy(embed).bfloat16()
    i, m = torch.from_numpy(idx), torch.from_numpy(mask)
    if kind == "rows":
        g = torch.randn(idx.size, embed.shape[1],
                        generator=torch.Generator().manual_seed(8)
                        ).bfloat16()
        grad = _bf16_grad(gather.gather_rows, e, lambda fn, leaf: (
            fn(leaf, i.reshape(-1)).float() * g.float()).sum())
        terms = g
    else:
        g = torch.randn(idx.shape[0], embed.shape[1],
                        generator=torch.Generator().manual_seed(8)
                        ).bfloat16()
        fn = agg.mean_aggregate if kind == "mean" else agg.max_aggregate
        grad = _bf16_grad(fn, e, lambda fn, leaf: (
            fn(leaf, i, m).float() * g.float()).sum())
        terms = (_mean_terms(g, m) if kind == "mean"
                 else _max_terms(g, e, i, m))
    assert torch.equal(grad, _sequential_scatter(terms, i, e.shape[0]))
    flat = i.reshape(-1).long()
    exact = torch.zeros(grad.shape, dtype=torch.float64).index_add_(
        0, flat, terms.double())
    absum = torch.zeros_like(exact).index_add_(0, flat, terms.double().abs())
    n = torch.bincount(flat, minlength=e.shape[0]).double()[:, None]
    assert ((grad.double() - exact).abs()
            <= (n + 1) * 2.0**-8 * absum).all()
    assert _report(f"{kind} bf16 on the CPU", grad, i, terms,
                   e.shape[0]) >= 1000


# ------------------------------------------------ collectives on the card

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_at_world_1_on_nccl(dtype):
    """The distributed pipelines' collectives at world 1 on the card go to
    NCCL (no shortcut): all_gather_rows and all_to_all_rows forward are
    copies, and their backward (the SUM reduce-scatter, the reverse
    all_to_all) hands the gradient back unchanged; mean_over_ranks of one
    rank is the tensor.  The halo exchange of one rank is the row
    gather."""
    import torch.distributed as dist

    from graphsage_torch.parallel import comm, multihost
    from graphsage_torch.parallel.halo import halo_gather_local, plan_halo

    dev = _card()
    owned = not dist.is_initialized()
    multihost.initialize()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(64, 24, generator=gen).to(dev, dtype)
        cot = torch.randn(64, 24, generator=gen).to(dev, dtype)
        for fn, shape in ((comm.all_gather_rows, (64, 24)),
                          (comm.all_to_all_rows, (1, 64, 24))):
            leaf = x.reshape(shape).clone().requires_grad_(True)
            out = fn(leaf)
            assert torch.equal(out, leaf.detach())
            out.backward(cot.reshape(shape))
            torch.cuda.synchronize()
            assert torch.equal(leaf.grad, cot.reshape(shape))
        req = torch.arange(16, dtype=torch.int32, device=dev).reshape(1, 16)
        assert torch.equal(comm.all_to_all_rows(req), req)
        a = torch.randn(5, generator=gen).to(dev)
        assert torch.equal(comm.mean_over_ranks([a])[0], a)
        ids = np.random.RandomState(4).randint(0, 64, (1, 40))
        plan = plan_halo(ids, 64, 1, exclude_self=False)
        t = {k: torch.from_numpy(getattr(plan, k)[0]).to(dev) for k in (
            "requests", "addr_owner", "addr_slot", "addr_is_local",
            "addr_local")}
        before = agg.LAUNCHES["gather_rows"]
        got = halo_gather_local(x, t["requests"], t["addr_owner"],
                                t["addr_slot"], t["addr_is_local"],
                                t["addr_local"])
        torch.cuda.synchronize()
        assert agg.LAUNCHES["gather_rows"] == before + 3
        assert torch.equal(got, x[torch.from_numpy(ids[0]).to(dev)])
    finally:
        if owned:
            multihost.shutdown()


# ------------------------------------------- the bfloat16 pretransform

# The kernel against the plain version (cuBLAS's float32 product of the
# pieces): each element within the three-piece bar of
# tests/test_torch_pretransform.py; both round the same exact products'
# float32 sums, in other orders (the tensor cores add a k-step's products
# together, then into the sum), so fewer elements than on the CPU are
# identical: 99.88% at [1M, 602] on an H100.
CARD_IDENTICAL = 0.995

# (rows, K, P, columns of h before its first: a strided view when > 0)
PRETRANSFORM_CASES = {
    "layer1_602": (1037, 602, 256, 0),     # 4-byte units, a K tail of 26
    "layer2_128": (1037, 128, 256, 0),     # 16-byte units
    "k10": (300, 10, 256, 0),              # one partial slice
    "cora1433": (257, 1433, 256, 0),       # odd K: 2-byte units
    "pubmed500": (130, 500, 256, 0),       # 8-byte units
    "gcn": (1000, 602, 128, 0),            # a 128-wide tile
    "narrow": (129, 64, 32, 0),            # a 64-wide tile, P < 64
    "wide384": (200, 96, 384, 0),          # two column tiles
    "one_row": (1, 602, 256, 0),
    "view": (515, 128, 256, 3),            # row stride 131, 2-byte units
    "p100": (300, 64, 100, 0),             # rows of z not 16-byte multiples
    "p_odd": (200, 64, 37, 0),             # an odd P
}


def _pretransform_inputs(n, k, p, skip, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, k + skip, generator=gen, device=dev).bfloat16()
    a = math.sqrt(6.0 / (2 * k + p // 2))
    w = (torch.rand(p, k, generator=gen, device=dev) * 2 - 1) * a
    return h[:, skip:], w


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PRETRANSFORM_CASES))
def test_pretransform_kernel_matches_plain_on_card(case):
    dev = _card()
    h, w = _pretransform_inputs(*PRETRANSFORM_CASES[case], dev)
    before = agg.LAUNCHES["pretransform"]
    got = pt.pretransform(h, w)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["pretransform"] == before + 1
    want = pt.pretransform_plain(h, pt.split_weight(w))
    assert_three_piece_bar(got, want, h, w, identical=CARD_IDENTICAL)
    # the kernel sums each row alike wherever the row lies
    assert torch.equal(pt.pretransform(h[1:], w), got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("p,k", [(256, 602), (128, 10), (100, 129),
                                 (384, 64)])
def test_pretransform_pack_kernel_matches_split_and_pack_on_card(p, k):
    """The card's split of the weight into the kernel's layout equals
    pack_pieces(split_weight(w)) bit for bit, signed zeros, tiny and huge
    values and values just below a power of two included."""
    dev = _card()
    gen = torch.Generator().manual_seed(p + k)
    w = torch.randn(p, k, generator=gen) * 0.1
    special = torch.tensor([0.0, -0.0, 1e-30, -1e30, 2.0 - 2.0**-23,
                            0.5 - 2.0**-25, 2.0**-110, 3.0e38])
    w.view(-1)[:special.numel()] = special
    w = w.to(dev)
    bn = pt.pretransform_plan(0, 2 * k, 2 * k, p)[1]
    lib = build.load_library("pretransform")
    want = pt.pack_pieces(pt.split_weight(w), bn)
    got = torch.empty(want.numel(), dtype=torch.bfloat16, device=dev)
    rc = lib.gs_pretransform_pack(
        dev.index or 0, w.data_ptr(), w.stride(0), got.data_ptr(), p, k, bn,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(got.view(torch.int16),
                       want.reshape(-1).view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [602, 128])
def test_pretransform_kernel_at_the_serving_shapes_on_card(k):
    """[1M, K] -> 256, serving's two MEAN layers on config 5."""
    dev = _card()
    h, w = _pretransform_inputs(1_000_000, k, 256, 0, dev, seed=k)
    got = pt.pretransform(h, w)
    want = pt.pretransform_plain(h, pt.split_weight(w))
    assert_three_piece_bar(got, want, h, w, identical=CARD_IDENTICAL)


@pytest.mark.gpu
def test_mean_pretransform_takes_the_kernel_where_autograd_would_not_record(
        ):
    from graphsage_torch.models.layers import mean_pretransform
    dev = _card()
    h, w = _pretransform_inputs(300, 64, 128, 0, dev)
    w = torch.cat([w, w.flip(0)], dim=1)[:64]           # [H, 2D]
    before = agg.LAUNCHES["pretransform"]
    with torch.no_grad():
        mean_pretransform(w, h.float())                 # a float32 table
    h.requires_grad_(True)
    mean_pretransform(w, h)                             # differentiated
    assert agg.LAUNCHES["pretransform"] == before
    with torch.no_grad():
        z = mean_pretransform(w, h)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["pretransform"] == before + 1
    assert z.shape == (300, 128) and z.dtype == torch.bfloat16


# ------------------------ the pool transform's bias-and-relu epilogue

POOL_SHAPES = [(4096, 602, 512), (4096, 256, 512)]    # GraphSAGE-pool layers


def _exact_sum_inputs(n, k, p, dev, seed=0):
    """Inputs whose float32 sums are exact in any order, so that the kernel
    and the plain version agree bit for bit: h in {-1, 0, 1} with at most 4
    nonzeros a row, w = j 2^-21 with |j| < 2^21 (21 significant bits: all
    three pieces nonzero), bias = j 2^-21 with |j| < 2^21.  Every partial
    sum is a multiple of 2^-21 under 5 in magnitude: 24 bits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randint(-1, 2, (n, k), generator=gen, device=dev).float()
    keep = torch.rand(n, k, generator=gen, device=dev).argsort(1) < 4
    h = (h * keep).bfloat16()
    w = torch.randint(-2**21 + 1, 2**21, (p, k), generator=gen,
                      device=dev).float() * 2.0**-21
    bias = torch.randint(-2**21 + 1, 2**21, (p,), generator=gen,
                         device=dev).float() * 2.0**-21
    return h, w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,p", POOL_SHAPES)
def test_pretransform_epilogue_matches_plain_bit_for_bit_on_card(n, k, p):
    """relu(h @ w.T + bias), rounded once: the epilogue kernel equals
    pretransform_plain with the bias bit for bit where the sums are exact,
    and on random inputs keeps the three-piece bar; a zero bias gives the
    relu of the epilogue-free kernel's z bit for bit (the same sums, and
    rounding commutes with relu)."""
    dev = _card()
    h, w, bias = _exact_sum_inputs(n, k, p, dev, seed=k)
    before = agg.LAUNCHES["pretransform"]
    got = pt.pretransform(h, w, bias=bias)
    torch.cuda.synchronize()
    assert agg.LAUNCHES["pretransform"] == before + 1
    want = pt.pretransform_plain(h, pt.split_weight(w), bias)
    assert torch.equal(got, want)
    assert (got == 0).float().mean() > 0.2       # the relu cuts
    h, w = _pretransform_inputs(n, k, p, 0, dev, seed=k + 1)
    bias = torch.randn(p, device=dev) * 0.1
    got = pt.pretransform(h, w, bias=bias)
    want = pt.pretransform_plain(h, pt.split_weight(w), bias)
    assert_three_piece_bar(got, want, h, w, identical=CARD_IDENTICAL)
    zero = pt.pretransform(h, w, bias=torch.zeros(p, device=dev))
    assert torch.equal(zero, torch.relu(pt.pretransform(h, w)))


@pytest.mark.gpu
def test_mean_and_pool_launch_their_own_kernels_on_card():
    """MEAN's call launches ``pretransform_kernel`` (no epilogue) and the
    pool transform ``pretransform_bias_relu_kernel``, by the profiler's
    kernel names."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    h, w = _pretransform_inputs(1037, 602, 256, 0, dev)
    pt.pretransform(h, w)                        # built and loaded
    names = []
    for bias in (None, torch.zeros(256, device=dev)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pt.pretransform(h, w, bias=bias)
            torch.cuda.synchronize()
        names.append({e.key for e in prof.key_averages()
                      if "pretransform" in e.key})
    assert any("pretransform_kernel" in k for k in names[0]), names
    assert not any("bias_relu" in k for k in names[0]), names
    assert any("pretransform_bias_relu_kernel" in k for k in names[1]), names


@pytest.mark.gpu
def test_pool_transform_takes_the_epilogue_where_autograd_would_not_record():
    from graphsage_torch.models.layers import pool_transform
    dev = _card()
    h, w = _pretransform_inputs(300, 64, 512, 0, dev)
    params = {"weight": w, "bias": torch.randn(512, device=dev) * 0.1}
    before = agg.LAUNCHES["pretransform"]
    with torch.no_grad():
        z = pool_transform(params, h)
    h.requires_grad_(True)
    pool_transform(params, h)                       # differentiated
    torch.cuda.synchronize()
    assert agg.LAUNCHES["pretransform"] == before + 1
    assert z.shape == (300, 512) and z.dtype == torch.bfloat16
    assert torch.equal(z, pt.pretransform(h.detach(), w, params["bias"]))
