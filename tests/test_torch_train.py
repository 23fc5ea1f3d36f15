"""The port's training path (graphsage_torch.models.graphsage,
.ops.aggregate's gather-mean and gather-max backwards, .train, .cli) against
the JAX package's, on the CPU, from the same numpy inputs, the same sampled
frontiers and the same initial weights (carried over with params_from_jax).

Tolerances:
- encoder forward and parameter gradients: rtol 1e-5, atol 1e-6 (float32,
  the same sums and products in another order);
- gather-mean and gather-max backwards: rtol=atol=1e-6 (one product, a
  division by the tie count and a sum per slot);
- one training epoch (10 steps, lr 0.7), MEAN, MAX and LSTM: step losses
  rtol 1e-4, final params atol 2e-4.  Both trainers see bit-identical
  batches (LSTM: bit-identical shuffled slots); the differences are float32
  roundings of the same arithmetic taken in another order, carried through
  the SGD updates.  Measured on a CPU for MEAN: at most 3.2e-6 relative on
  a loss and 1.2e-5 on a weight (of ~0.75).  MAX and LSTM: sup runs free
  at these bounds; plus_unsup runs in lockstep from the JAX params of each
  step (free, its rounding differences reach 1e-2 relative within 10
  steps), each step's update within atol 2e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.models import graphsage as jax_graphsage
from graphsage_tpu.models import init_graphsage as jax_init_graphsage
from graphsage_tpu.ops import aggregate as jax_agg
from graphsage_tpu.ops.pallas_aggregate import (_pallas_max_bwd,
                                                _pallas_mean_bwd)
from graphsage_tpu.sampler import build_compact_batch as jax_build
from graphsage_tpu.train import Trainer as JaxTrainer
from graphsage_tpu.train import TrainConfig as JaxTrainConfig
from graphsage_tpu.train.optim import clip_by_global_norm as jax_clip
from graphsage_torch import cli, infer
from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import GraphSageConfig, graphsage
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.train import Trainer, TrainConfig
from graphsage_torch.train.optim import clip_by_global_norm, sgd_update
from graphsage_torch.train.trainer import _frontiers, _leaf_params
from graphsage_torch.utils.config import HoconSubsetError
from tests.test_torch_aggregate import _case

ENC = dict(rtol=1e-5, atol=1e-6)


def _port_cfg(jcfg):
    return GraphSageConfig(**dataclasses.asdict(jcfg))


# ------------------------------------------------------------ encoder

@pytest.mark.parametrize("layout", [
    dict(n=300, mean_pretransform="auto"),            # table transformed
    dict(n=3000, mean_pretransform="auto"),           # layer rule decides
    dict(n=300, mean_pretransform="never"),           # no pretransform
    dict(n=300, mean_pretransform="always", gcn=True),
    dict(n=300, mean_pretransform="auto", impl="pallas"),
], ids=["apply_table", "layer_rule", "never", "always_gcn", "pallas_opt_out"])
def test_encoder_forward_and_grads_match_jax(layout):
    layout = dict(layout)
    n = layout.pop("n")
    ds = jax_power_law(n, 5 * n, num_feats=48, seed=3)
    jcfg = JaxConfig(num_layers=2, input_size=48, out_size=8, **layout)
    params = jax.device_get(jax_init_graphsage(jax.random.PRNGKey(1), jcfg))
    batch = np.random.RandomState(2).choice(n, 40, replace=False)
    cb = jax_build(ds.graph, batch, np.random.RandomState(3), num_layers=2,
                   fanout=5, gcn=jcfg.gcn)
    x0 = cb.x0_ids
    table_rule = n <= 2 * len(x0)
    assert table_rule == (n == 300)
    w_out = np.random.RandomState(4).randn(cb.out_rows, 8).astype(np.float32)

    def jax_loss(p):
        out = jax_graphsage.graphsage_apply_gathered(
            p, jcfg, jnp.asarray(ds.features), jnp.asarray(x0),
            [jax_graphsage.Frontier(*map(jnp.asarray, (f.idx, f.mask,
                                                       f.self_idx)))
             for f in cb.frontiers])
        return jnp.sum(jnp.sin(out) * w_out), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        params)
    p = {"layers": [{"weight": torch.from_numpy(np.array(l["weight"]))
                     .requires_grad_(True)} for l in params["layers"]]}
    got = graphsage.graphsage_apply_gathered(
        p, _port_cfg(jcfg), torch.from_numpy(ds.features),
        torch.from_numpy(x0), _frontiers(cb, torch.device("cpu")))
    (torch.sin(got) * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ENC)
    for layer, jlayer in zip(p["layers"], want_grads["layers"]):
        np.testing.assert_allclose(layer["weight"].grad.numpy(),
                                   np.asarray(jlayer["weight"]), **ENC)


def test_use_pretransform_rule_matches_jax():
    rng = np.random.RandomState(0)
    for m, u, d, mode, impl in [(100, 50, 8, "auto", "xla"),
                                (101, 50, 8, "auto", "xla"),
                                (199, 50, 64, "auto", "xla"),
                                (201, 50, 64, "auto", "xla"),
                                (500, 10, 8, "always", "xla"),
                                (10, 50, 8, "never", "xla"),
                                (10, 50, 8, "auto", "pallas")]:
        jcfg = JaxConfig(num_layers=2, input_size=d, out_size=16,
                         mean_pretransform=mode, impl=impl)
        h = rng.randn(m, d).astype(np.float32)
        idx = np.zeros((u, 3), np.int32)
        f = jax_graphsage.Frontier(idx, idx.astype(np.float32), idx[:, 0])
        assert (graphsage._use_pretransform(_port_cfg(jcfg),
                                            torch.from_numpy(h), f)
                == jax_graphsage._use_pretransform(jcfg, jnp.asarray(h), f))


def test_unported_training_configs_raise():
    ds = synthetic_power_law(100, 400, num_feats=8, seed=0)
    cfg = GraphSageConfig(num_layers=2, input_size=8, out_size=4,
                          compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(ds, cfg, TrainConfig(verbose=False), device="cpu")
    with pytest.raises(ValueError, match="agg_func"):
        Trainer(ds, GraphSageConfig(num_layers=2, input_size=8, out_size=4,
                                    agg_func="SUM"),
                TrainConfig(verbose=False), device="cpu")


# ------------------------------------------------------------ gather-mean

@pytest.mark.parametrize("case", ["random", "empty_rows", "unaligned"])
def test_gather_mean_backward_matches_jax(case):
    """The gather-mean Function's gradient against JAX's _pallas_mean_bwd,
    and through a strided view (the pretransform's h_cat[:, H:])."""
    embed, idx, mask = _case(case, seed=5)
    g = np.random.RandomState(6).randn(idx.shape[0],
                                       embed.shape[1]).astype(np.float32)
    want, _, _ = _pallas_mean_bwd(True, "mean", (jnp.asarray(embed),
                                                 jnp.asarray(idx),
                                                 jnp.asarray(mask)),
                                  jnp.asarray(g))
    e = torch.from_numpy(embed).requires_grad_(True)
    (agg.mean_aggregate(e, torch.from_numpy(idx), torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

    wide = torch.from_numpy(np.concatenate([embed, embed], axis=1)
                            ).requires_grad_(True)
    d = embed.shape[1]
    (agg.mean_aggregate(wide[:, d:], torch.from_numpy(idx),
                        torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    assert not wide.grad[:, :d].any()
    np.testing.assert_array_equal(wide.grad[:, d:].numpy(), e.grad.numpy())


def _tie_case():
    """embed rows duplicated so that slots tie: row 0 of the output has 3
    valid slots holding the maximum in column 0 and 2 in column 1, and a
    masked slot that ties too; row 1 ties twice in every column; row 2 has
    no valid slot; row 3 is random."""
    rng = np.random.RandomState(8)
    embed = rng.randn(9, 4).astype(np.float32)
    embed[0] = [5.0, 1.0, -1.0, 0.0]
    embed[1] = [5.0, 4.0, -2.0, 0.0]
    embed[2] = [5.0, 4.0, -3.0, 0.0]
    embed[3] = [5.0, 9.0, 7.0, 0.0]              # masked in row 0
    embed[4] = embed[5] = rng.randn(4).astype(np.float32) + 3.0
    idx = np.array([[0, 1, 2, 3, 6],
                    [4, 5, 7, 5, 8],
                    [0, 1, 2, 3, 4],
                    [3, 8, 6, 1, 7]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0],
                     [1, 1, 0, 0, 0],
                     [0, 0, 0, 0, 0],
                     [1, 0, 1, 1, 1]], np.float32)
    return embed, idx, mask


def _max_bwd_case(case):
    """(embed, idx, mask, g) of a max-backward case: the tie case, _case's
    random and empty_rows, and the edges of the tie split: g holding +inf,
    -inf and NaN (inf * 0 is NaN on every slot of that column, masked ones
    too), ties between +0 and -0 (== has them tie) with negative g (the
    untied slots' shares are -0), every slot of some rows masked, and 33
    slots (past one 32-bit mask of the card's kernel)."""
    rng = np.random.RandomState(10)
    if case in ("ties", "nonfinite"):
        embed, idx, mask = _tie_case()
    elif case == "signed_zeros":
        embed = rng.randn(7, 5).astype(np.float32)
        embed[0] = [0.0, -0.0, 0.0, -1.0, 2.0]
        embed[1] = [-0.0, 0.0, -0.0, -1.0, 2.0]
        embed[2] = [-3.0, -0.0, -2.0, -5.0, 2.0]
        idx = np.array([[0, 1, 2, 5], [1, 2, 0, 1], [2, 2, 6, 0]], np.int32)
        mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 1]],
                        np.float32)
    elif case == "s33":
        embed = rng.randn(40, 6).astype(np.float32)
        embed[20:] = embed[:20]
        embed[::7, 0] = 9.0
        idx = rng.randint(0, 40, (5, 33)).astype(np.int32)
        idx[:, 32] = 0                     # the 33rd slot ties at column 0
        mask = (rng.rand(5, 33) < 0.8).astype(np.float32)
        mask[:, 32] = 1.0
    else:
        embed, idx, mask = _case("empty_rows" if case == "all_masked"
                                 else case, seed=7)
    g = rng.randn(idx.shape[0], embed.shape[1]).astype(np.float32)
    if case == "nonfinite":
        g[0, :3] = [np.inf, -np.inf, np.nan]
        g[3, 2] = np.nan
        g[2, 0] = np.inf                   # a row with every slot masked
    elif case == "signed_zeros":
        g = -np.abs(g)
    elif case == "all_masked":
        mask[1::3] = 0.0
        g = -np.abs(g)
    return embed, idx, mask, g


def _assert_same(got: np.ndarray, want: np.ndarray):
    """Equal values, NaN where the other has NaN, and the same sign of
    every zero: bit for bit but for the payload and sign of a NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(got.astype(np.float32))
    np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float32)))
    np.testing.assert_array_equal(np.signbit(got[~nan].astype(np.float32)),
                                  np.signbit(want[~nan].astype(np.float32)))
    np.testing.assert_array_equal(got[~nan], want[~nan])


def _jax_tie_split(je, ji, jm, jout, jg):
    """_pallas_max_bwd's lines up to its scatter, in jnp: [U*S, D]."""
    gathered = jnp.take(je, ji, axis=0)
    is_max = ((gathered == jout[:, None, :])
              & (jm[:, :, None] > 0)).astype(jg.dtype)
    denom = jnp.maximum(jnp.sum(is_max, axis=1, keepdims=True), 1.0)
    contrib = jg[:, None, :] * is_max / denom
    return contrib.reshape(-1, je.shape[1]).astype(je.dtype)


MAX_BWD_CASES = ["ties", "random", "empty_rows", "nonfinite", "signed_zeros",
                 "all_masked", "s33"]


@pytest.mark.parametrize("case", MAX_BWD_CASES)
def test_gather_max_backward_matches_jax(case):
    """The gather-max Function's gradient against jax.grad of the XLA
    max_aggregate and against _pallas_max_bwd, at 2- and 3-way ties (with a
    masked slot that ties); autograd through the plain version gives the
    same equal split.  Every case also holds the Function's gradient
    against _pallas_max_bwd's in float32 and bfloat16 (equal, NaN for NaN),
    and max_tie_split_plain's contributions against the same lines of
    _pallas_max_bwd in jnp bit for bit; where g is not finite, jax.grad
    and autograd through amax route it otherwise (no inf * 0 on the
    untied slots), so only those two comparisons hold there."""
    embed, idx, mask, g = _max_bwd_case(case)
    ja = tuple(map(jnp.asarray, (embed, idx, mask)))
    out = jax_agg.max_aggregate(*ja)
    want_pallas, _, _ = _pallas_max_bwd(True, "max", (*ja, out),
                                        jnp.asarray(g))
    if case != "nonfinite":
        want = jax.grad(lambda e: jnp.sum(jax_agg.max_aggregate(e, *ja[1:])
                                          * g))(ja[0])
        np.testing.assert_allclose(np.asarray(want_pallas), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        for fn in (agg.max_aggregate, agg.max_aggregate_plain):
            e = torch.from_numpy(embed).requires_grad_(True)
            got = fn(e, torch.from_numpy(idx), torch.from_numpy(mask))
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(out))
            (got * torch.from_numpy(g)).sum().backward()
            np.testing.assert_allclose(e.grad.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    i, m = torch.from_numpy(idx), torch.from_numpy(mask)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        e = torch.from_numpy(embed).to(tdt)
        gt = torch.from_numpy(g).to(tdt)
        t_out = agg.max_aggregate(e, i, m)
        je, jg = jnp.asarray(embed, dtype=jdt), jnp.asarray(g, dtype=jdt)
        jout = jnp.asarray(t_out.float().numpy(), dtype=jdt)
        contrib = agg.max_tie_split_plain(gt, e, i, m, t_out)
        assert contrib.shape == (idx.size, embed.shape[1])
        _assert_same(contrib.float().numpy(), np.asarray(
            _jax_tie_split(je, ja[1], ja[2], jout, jg)).astype(np.float32))
        leaf = e.clone().requires_grad_(True)
        agg.max_aggregate(leaf, i, m).backward(gt)
        want_t, _, _ = _pallas_max_bwd(True, "max", (je, ja[1], ja[2], jout),
                                       jg)
        assert leaf.grad.dtype == tdt
        _assert_same(leaf.grad.float().numpy(),
                     np.asarray(want_t).astype(np.float32))
    if case == "nonfinite":
        # inf * 0: NaN on every untied slot of those columns, masked slots
        # too (the tied ones take +-inf / c, or NaN)
        rows = contrib.float().view(idx.shape[0], idx.shape[1], -1)
        assert not torch.isfinite(rows[0, :, :3]).any()
        assert torch.isnan(rows[0, 3:, :3]).all()     # masked slots
        assert torch.isnan(rows[2, :, 0]).all() and not mask[2].any()
        assert not torch.isnan(rows[1]).any()
    if case == "signed_zeros":
        # +0 and -0 tie; an untied slot's share of a negative g is -0
        # (contrib is the bfloat16 loop's)
        rows = contrib.float().view(idx.shape[0], idx.shape[1], -1)
        half = float(torch.tensor(g[0, 0] / 2).bfloat16())
        assert float(rows[0, 0, 0]) == float(rows[0, 1, 0]) == half < 0
        assert rows[0, 2, 0] == 0 and torch.signbit(rows[0, 2, 0])
    if case == "ties":
        # row 0 alone: the 3-way and 2-way ties split equally, and the
        # masked slot that ties (embed row 3) gets nothing
        e = torch.from_numpy(embed).requires_grad_(True)
        g0 = np.zeros_like(g)
        g0[0] = g[0]
        (agg.max_aggregate(e, torch.from_numpy(idx), torch.from_numpy(mask))
         * torch.from_numpy(g0)).sum().backward()
        d = e.grad.numpy()
        np.testing.assert_allclose(d[[0, 1, 2], 0], g[0, 0] / 3, rtol=1e-6)
        np.testing.assert_allclose(d[[1, 2], 1], g[0, 1] / 2, rtol=1e-6)
        assert d[0, 1] == 0 and not d[3].any()


def test_max_backward_goes_through_the_function_on_both_devices():
    """max_aggregate is an autograd Function whose backward is
    max_aggregate_backward on the CPU as on the card."""
    embed, idx, mask = _case("random")
    e = torch.from_numpy(embed).requires_grad_(True)
    out = agg.max_aggregate(e, torch.from_numpy(idx), torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_GatherMaxBackward"
    out.sum().backward()
    want = agg.max_aggregate_backward(torch.ones_like(out), e.detach(),
                                      torch.from_numpy(idx),
                                      torch.from_numpy(mask), out.detach())
    assert torch.equal(e.grad, want)


# ------------------------------------------------------------ optimizer

def test_clip_and_sgd_match_jax():
    rng = np.random.RandomState(1)
    grads = [rng.randn(5, 4).astype(np.float32) * 3,
             rng.randn(7).astype(np.float32)]
    params = [rng.randn(5, 4).astype(np.float32),
              rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 1e4):     # clipped, and left alone
        want = jax_clip([jnp.asarray(x) for x in grads], max_norm)
        got = clip_by_global_norm([torch.from_numpy(x) for x in grads],
                                  max_norm)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    tp = [torch.from_numpy(p.copy()) for p in params]
    sgd_update(tp, [torch.from_numpy(x) for x in grads], 0.7)
    for x, p, g in zip(tp, params, grads):
        np.testing.assert_array_equal(x.numpy(), p - np.float32(0.7) * g)


# ------------------------------------------------------------ trainer

@pytest.fixture(scope="module")
def datasets():
    """synthetic_power_law(2000, 10000, 64 features) from both packages, the
    train split cut to its first 200 nodes (10 steps of 20)."""
    jds = jax_power_law(2000, 10000, num_feats=64, seed=1)
    ds = synthetic_power_law(2000, 10000, num_feats=64, seed=1)
    return (dataclasses.replace(ds, train_nodes=ds.train_nodes[:200]),
            dataclasses.replace(jds, train_nodes=jds.train_nodes[:200]))


def _run_both(datasets, model=None, **tcfg):
    ds, jds = datasets
    jm = JaxConfig(num_layers=2, input_size=64, out_size=16, **(model or {}))
    jt = JaxTrainConfig(epochs=1, b_sz=20, seed=5, verbose=False, **tcfg)
    jtr = JaxTrainer(jds, jm, jt)
    params0 = jax.device_get(jtr.params)
    jax_losses = []
    step = jtr._step_fn

    def recording_step(*args):
        out = step(*args)
        jax_losses.append(float(out[1]))
        return out

    jtr._step_fn = recording_step
    tr = Trainer(ds, _port_cfg(jm), TrainConfig(epochs=1, b_sz=20, seed=5,
                                                verbose=False, **tcfg),
                 params=params0, device="cpu")
    return jtr, tr, jax_losses


@pytest.mark.parametrize("learn_method,unsup_loss", [
    ("sup", "normal"), ("plus_unsup", "normal"), ("plus_unsup", "margin")])
def test_trainer_matches_jax_step_for_step(datasets, learn_method,
                                           unsup_loss, monkeypatch):
    # uniform negatives: on this small graph every train node lies within
    # 5 hops of every other, so exact mode would find no negatives
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    jtr, tr, jax_losses = _run_both(datasets, learn_method=learn_method,
                                    unsup_loss=unsup_loss)
    want_mean = jtr.train_epoch()
    got_mean = tr.train_epoch()
    assert len(tr.step_losses) == len(jax_losses) == 10
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-4)
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-4)
    want = jax.device_get(jtr.params)
    got = jax.tree_util.tree_map(lambda x: x.detach().numpy(), tr.params)
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    # the host RNG streams stayed in step
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)
    jtr.evaluate()
    tr.evaluate()
    assert tr.history[-1]["val_f1"] == pytest.approx(
        jtr.history[-1]["val_f1"], abs=0.01)


@pytest.mark.parametrize("agg_func,learn_method,gcn", [
    ("MAX", "sup", False), ("MAX", "sup", True),
    ("MAX", "plus_unsup", False), ("MAX", "plus_unsup", True),
    ("LSTM", "sup", False), ("LSTM", "plus_unsup", True)])
def test_max_and_lstm_trainers_match_jax_step_for_step(
        datasets, agg_func, learn_method, gcn, monkeypatch):
    """A 10-step epoch of compact MAX (gather-max with its tie-splitting
    backward) and LSTM (shuffled slots, the cell on every layer) against
    the JAX Trainer (impl "xla"), then one evaluation.  sup runs free.
    plus_unsup runs in lockstep: each port step starts from the JAX
    params of that step, and its loss and update are compared (free, the
    unsupervised loss at lr 0.7 carries a rounding difference to 1e-2
    relative within 10 steps for MAX and LSTM)."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    jtr, tr, jax_losses = _run_both(datasets,
                                    model=dict(agg_func=agg_func, gcn=gcn),
                                    learn_method=learn_method)
    if agg_func == "LSTM":
        assert [c["w_ih"].shape[1] for c in tr.params["sage"]["agg"]] == [
            64, 16]
    lockstep = learn_method == "plus_unsup"
    jax_params = []
    jax_step = jtr._step_fn

    def recording(params, *args):
        out = jax_step(params, *args)
        jax_params.append((jax.device_get(params), jax.device_get(out[0])))
        return out

    jtr._step_fn = recording
    jtr.train_epoch()
    port_step, step_errs = tr._step, []

    def from_jax_params(*args):
        before, after = jax_params[len(step_errs)]
        with torch.no_grad():
            for p, q in zip(jax.tree_util.tree_leaves(tr.params),
                            jax.tree_util.tree_leaves(before)):
                p.copy_(torch.from_numpy(np.array(q)))
        loss = port_step(*args)
        step_errs.append(max(
            float(np.abs(p.detach().numpy() - np.asarray(q)).max())
            for p, q in zip(jax.tree_util.tree_leaves(tr.params),
                            jax.tree_util.tree_leaves(after))))
        return loss

    if lockstep:
        tr._step = from_jax_params
    tr.train_epoch()
    assert len(tr.step_losses) == len(jax_losses) == 10
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-4)
    want = jax.device_get(jtr.params)
    got = jax.tree_util.tree_map(lambda x: x.detach().numpy(), tr.params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    if lockstep:
        assert len(step_errs) == 10 and max(step_errs) <= 2e-4, step_errs
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)
    jtr.evaluate()
    tr.evaluate()
    assert tr.history[-1]["val_f1"] == pytest.approx(
        jtr.history[-1]["val_f1"], abs=0.01)


def test_unsup_trains_the_classifier_like_jax(datasets, monkeypatch):
    """unsup with clf_epochs=1: the classifier-only fit on frozen
    embeddings.  Unsupervised SGD at lr 0.7 doubles a rounding difference
    about every step (1e-7 at step 2, 1.5e-5 at step 10), so the encoder
    is held for one epoch and then carried over from JAX before the
    classifier phase, which is compared on its own."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    jtr, tr, jax_losses = _run_both(datasets, learn_method="unsup",
                                    clf_epochs=1, emb_b_sz=1000)
    jtr.train_epoch()
    tr.train_epoch()
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-4)
    tr.params["sage"] = _leaf_params(jax.device_get(jtr.params["sage"]),
                                     torch.device("cpu"))
    jtr.epoch = tr.epoch = 1
    assert tr.train_classification() == jtr.train_classification()
    assert tr.history == jtr.history
    want = jax.device_get(jtr.params["clf"])
    for name in ("weight", "bias"):
        np.testing.assert_allclose(tr.params["clf"][name].detach().numpy(),
                                   want[name], rtol=0, atol=1e-5)
    assert tr.rng.randint(2**31) == jtr.rng.randint(2**31)


def test_unsup_fit_fits_the_classifier_every_second_epoch(datasets,
                                                          monkeypatch):
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    ds, _ = datasets
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(learn_method="unsup", epochs=2, b_sz=100,
                             lr=0.1, clf_epochs=2, emb_b_sz=1000,
                             verbose=False), device="cpu")
    tr.fit()
    assert [h["epoch"] for h in tr.history] == [1, 1]


def test_trainer_without_a_card_or_device_raises(datasets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, _ = datasets
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ds, GraphSageConfig(num_layers=2, input_size=64, out_size=8),
                TrainConfig(verbose=False))


def test_params_carried_over_are_copies(datasets):
    ds, _ = datasets
    start = {"sage": {"layers": [{"weight": np.ones((8, 128), np.float32)},
                                 {"weight": np.ones((8, 16), np.float32)}]},
             "clf": {"weight": np.ones((ds.num_classes, 8), np.float32),
                     "bias": np.zeros(ds.num_classes, np.float32)}}
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(verbose=False, b_sz=100), params=start,
                 device="cpu")
    tr.train_epoch()
    assert (start["sage"]["layers"][0]["weight"] == 1).all()
    assert params_from_jax(start)["clf"]["weight"].dtype == torch.float32


# ------------------------------------------------------------ CLI

def test_cli_trains_exports_and_serves(tmp_path, capsys):
    out = str(tmp_path / "bundle")
    argv = ["--dataSet", "powerlaw:300:1200", "--learn_method", "plus_unsup",
            "--epochs", "1", "--b_sz", "50", "--hidden", "16",
            "--device", "cpu", "--export", out, "--seed", "3",
            "--checkpoint_dir", str(tmp_path / "ck")]
    assert cli.main(argv) == 0
    assert "Best validation F1" in capsys.readouterr().out
    params, mcfg, ncls, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val" and mcfg.out_size == 16

    trainer, best = cli.run(argv + ["--quiet"])
    again, _, _, _ = infer.load_bundle(out)
    for w, g in zip(jax.tree_util.tree_leaves(best["params"]),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(g, w)     # the best-val snapshot
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features,
                                              trainer.ds.graph.to_padded(),
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features,
                                       trainer.ds.graph.to_padded(),
                                       device="cpu")
    np.testing.assert_allclose(sess.embeddings(), want, rtol=1e-5,
                               atol=1e-5)
    assert sess.predict(trainer.ds.val_nodes).shape == (
        len(trainer.ds.val_nodes),)


@pytest.mark.parametrize("flags,world,error,match", [
    pytest.param(["--pipeline", "cached_dist"], "2", RuntimeError,
                 "refusing to run as world 1",
                 id="flags0-RuntimeError-world 1"),
    pytest.param(["--pipeline", "dist"], "2", RuntimeError,
                 "refusing to run as world 1",
                 id="flags1-RuntimeError-world 1"),
    pytest.param(["--resume", "{tmp}/no_such_checkpoint"], None,
                 FileNotFoundError, "no_such_checkpoint",
                 id="flags2-FileNotFoundError-no_such_checkpoint"),
    pytest.param(["--config", "{tmp}/include.conf"], None, HoconSubsetError,
                 "'include'", id="flags3-HoconSubsetError-'include'"),
])
def test_cli_refuses_what_is_not_ported(flags, world, error, match,
                                        tmp_path, monkeypatch):
    """A distributed pipeline whose environment names a multi-process job
    it cannot join (WORLD_SIZE=2, no rendezvous), a checkpoint that is not
    there and a config file outside the HOCON subset fail loudly."""
    for name in ("RANK", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    (tmp_path / "include.conf").write_text('include "other.conf"\n')
    flags = [f.format(tmp=tmp_path) for f in flags]
    with pytest.raises(error, match=match):
        cli.main(["--dataSet", "powerlaw:100:400", "--device", "cpu",
                  "--epochs", "1", "--quiet", "--checkpoint_dir",
                  str(tmp_path / "ck"), *flags])


def test_cli_cached_lstm_needs_the_hybrid_flag():
    with pytest.raises(ValueError, match="lstm_hybrid"):
        cli.main(["--dataSet", "powerlaw:100:400", "--device", "cpu",
                  "--epochs", "1", "--quiet", "--pipeline", "cached",
                  "--agg_func", "LSTM"])


@pytest.mark.parametrize("agg_func", ["MAX", "LSTM"])
def test_cli_trains_max_and_lstm_exports_and_serves(agg_func, tmp_path,
                                                    monkeypatch):
    """--agg_func MAX / LSTM on the compact pipeline: trains, exports the
    best-val model (with its LSTM cells), and the bundle serves the same
    table as full_graph_embeddings of the snapshot."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    out = str(tmp_path / agg_func)
    trainer, best = cli.run([
        "--dataSet", "powerlaw:300:1200", "--agg_func", agg_func,
        "--learn_method", "plus_unsup", "--epochs", "1", "--b_sz", "100",
        "--hidden", "8", "--device", "cpu", "--export", out, "--seed", "3",
        "--quiet", "--checkpoint_dir", str(tmp_path / "ck")])
    assert type(trainer).__name__ == "Trainer"
    assert np.isfinite(trainer.step_losses).all()
    params, mcfg, _, meta = infer.load_bundle(out)
    assert mcfg.agg_func == agg_func and "lstm_hybrid" not in meta
    assert ("agg" in params["sage"]) == (agg_func == "LSTM")
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features, pad,
                                       device="cpu")
    np.testing.assert_array_equal(sess.embeddings(), want)
    assert np.isfinite(want).all() and np.abs(want).sum() > 0


def test_cli_cached_lstm_hybrid_exports_and_serves_the_hybrid(tmp_path):
    """--pipeline cached --agg_func LSTM --lstm_hybrid --export: the bundle
    records lstm_hybrid, and from_bundle serves the hybrid forward (MEAN at
    layer 1), not the all-LSTM one; the layer-0 cell is the initial one."""
    out = str(tmp_path / "hybrid")
    argv = ["--dataSet", "powerlaw:300:1200", "--pipeline", "cached",
            "--agg_func", "LSTM", "--lstm_hybrid", "--table_cap", "8",
            "--epochs", "2", "--b_sz", "50", "--hidden", "8",
            "--device", "cpu", "--export", out, "--seed", "3", "--quiet",
            "--checkpoint_dir", str(tmp_path / "ck")]
    trainer, best = cli.run(argv)
    assert type(trainer).__name__ == "CachedTrainer"
    params, mcfg, _, meta = infer.load_bundle(out)
    assert meta["lstm_hybrid"] is True and mcfg.agg_func == "LSTM"
    gen = torch.Generator().manual_seed(3)
    init = graphsage.init_graphsage(gen, mcfg)
    for k, v in init["agg"][0].items():
        np.testing.assert_array_equal(params["sage"]["agg"][0][k], v.numpy())
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    assert sess.lstm_hybrid
    hybrid = infer.full_graph_embeddings(params["sage"], mcfg,
                                         trainer.ds.features, pad,
                                         lstm_hybrid=True, device="cpu")
    np.testing.assert_array_equal(sess.embeddings(), hybrid)
    all_lstm = infer.full_graph_embeddings(params["sage"], mcfg,
                                           trainer.ds.features, pad,
                                           device="cpu")
    assert not np.allclose(all_lstm, hybrid)


def test_cli_cached_pipeline_trains_exports_and_serves(tmp_path,
                                                     monkeypatch):
    """--pipeline cached on the CPU with its flags, then the exported
    bundle served by InferenceSession.from_bundle."""
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    out = str(tmp_path / "cached")
    trainer, best = cli.run([
        "--dataSet", "powerlaw:300:1200", "--pipeline", "cached",
        "--table_cap", "8", "--refresh_every", "2", "--epochs", "2",
        "--learn_method", "plus_unsup", "--b_sz", "50", "--hidden", "16",
        "--device", "cpu", "--export", out, "--seed", "3", "--quiet",
        "--checkpoint_dir", str(tmp_path / "ck")])
    assert type(trainer).__name__ == "CachedTrainer"
    assert trainer.neighbors.shape[1] == 8 and len(trainer.history) == 2
    params, mcfg, _, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val" and mcfg.out_size == 16
    pad = trainer.ds.graph.to_padded()
    sess = infer.InferenceSession.from_bundle(out, trainer.ds.features, pad,
                                              device="cpu")
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       trainer.ds.features, pad,
                                       device="cpu")
    np.testing.assert_allclose(sess.embeddings(), want, rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(sess.embeddings()).all()


def test_metrics_sink_records_epochs(datasets, tmp_path):
    ds, _ = datasets
    path = str(tmp_path / "m.jsonl")
    tr = Trainer(ds, GraphSageConfig(num_layers=2, input_size=64,
                                     out_size=8),
                 TrainConfig(verbose=False, b_sz=100, epochs=1,
                             metrics_path=path, prefetch_depth=0),
                 device="cpu")
    tr.fit()
    import json
    events = [json.loads(l)["event"] for l in open(path)]
    assert events[0] == "epoch" and "eval" in events
    assert os.path.getsize(path) > 0
