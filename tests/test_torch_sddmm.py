"""The port's pair scores and losses (graphsage_torch.ops.sddmm,
graphsage_torch.losses) against the JAX package's (graphsage_tpu.ops.sddmm,
its Pallas kernel in interpret mode, and graphsage_tpu.losses), on the same
numpy inputs, on the CPU.

On the CPU ``PairScores`` runs the plain forward with the analytic backward
the card runs; the CUDA kernel is held against the plain version by
tests/test_torch_kernels.py on the card and by chip_smoke.py.

Tolerances: float32 rtol=atol=1e-5 (the same sums in another order);
bfloat16 scores within one bf16 ulp (both sides compute in float32 and
round once).  Losses rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu import losses as jax_losses
from graphsage_tpu.ops import aggregate as jax_agg
from graphsage_tpu.ops import sddmm as jax_sddmm
from graphsage_torch import losses
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import sddmm
from tests.test_torch_aggregate import bf16_ulps

F32 = dict(rtol=1e-5, atol=1e-5)


def _emb(u, h, seed=0, zero_rows=()):
    rng = np.random.RandomState(seed)
    emb = rng.randn(u, h).astype(np.float32)
    emb[list(zero_rows)] = 0.0
    return emb


def _targets(u, b, seed=1):
    t = np.random.RandomState(seed).randint(0, u, b).astype(np.int32)
    t[1] = t[0]        # a duplicate target exercises the scatter-add
    return t


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("shape", [(130, 40, 12), (1000, 100, 3),
                                   (64, 16, 20)],
                         ids=["unaligned", "ragged", "tiny"])
def test_scores_match_jax_f32(shape):
    u, h, b = shape
    emb, t = _emb(u, h, zero_rows=(0, 7)), _targets(u, b)
    t[2] = 7           # a zero-norm target row
    want = np.asarray(jax_sddmm.dense_pair_scores(jnp.asarray(emb),
                                                  jnp.asarray(t)))
    pallas = np.asarray(jax_sddmm.pallas_pair_scores(
        jnp.asarray(emb), jnp.asarray(t), interpret=True))
    for got in (sddmm.dense_pair_scores(_t(emb), _t(t)),
                sddmm.PairScores.apply(_t(emb), _t(t)),
                sddmm.pair_scores(_t(emb), _t(t))):
        assert got.dtype == torch.float32 and got.shape == (b, u)
        np.testing.assert_allclose(got.numpy(), want, **F32)
        np.testing.assert_allclose(got.numpy(), pallas, **F32)
        assert not got.numpy()[:, [0, 7]].any()
        assert not got.numpy()[2].any()


def test_scores_match_jax_bf16():
    emb, t = _emb(130, 40, seed=3), _targets(130, 12)
    e16 = jnp.asarray(emb, dtype=jnp.bfloat16)
    got = sddmm.PairScores.apply(
        torch.from_numpy(np.array(e16.astype(jnp.float32))).bfloat16(),
        _t(t))
    assert got.dtype == torch.bfloat16
    for want in (jax_sddmm.dense_pair_scores(e16, jnp.asarray(t)),
                 jax_sddmm.pallas_pair_scores(e16, jnp.asarray(t),
                                              interpret=True)):
        assert want.dtype == jnp.bfloat16
        assert bf16_ulps(got.float().numpy(),
                         np.asarray(want.astype(jnp.float32))).max() <= 1.0


def test_analytic_backward_matches_jax():
    """pair_scores_backward against JAX's _pallas_scores_bwd and against
    jax.vjp of dense_pair_scores; PairScores' gradient against autograd
    through the plain version."""
    u, h, b = 64, 16, 12
    emb, t = _emb(u, h, seed=7), _targets(u, b, seed=8)
    g = np.random.RandomState(9).randn(b, u).astype(np.float32)
    eps = 1e-8
    e_j, t_j, g_j = jnp.asarray(emb), jnp.asarray(t), jnp.asarray(g)
    norms = jnp.maximum(jnp.linalg.norm(e_j, axis=-1, keepdims=True), eps)
    want_bwd, _ = jax_sddmm._pallas_scores_bwd(
        eps, (e_j / norms, norms, t_j, jnp.zeros((0,), e_j.dtype)), g_j)
    _, vjp = jax.vjp(lambda e: jax_sddmm.dense_pair_scores(e, t_j), e_j)
    want_vjp = vjp(g_j)[0]

    got = sddmm.pair_scores_backward(_t(g), _t(emb), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_bwd), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_vjp), **F32)

    e = _t(emb).requires_grad_(True)
    (sddmm.PairScores.apply(e, _t(t)) * _t(g)).sum().backward()
    e_plain = _t(emb).requires_grad_(True)
    (sddmm.dense_pair_scores(e_plain, _t(t)) * _t(g)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), e_plain.grad.numpy(), **F32)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_vjp), **F32)


def _pair_case(u, h, b, p=3, m=7, seed=11):
    rng = np.random.RandomState(seed)
    emb = rng.randn(u, h).astype(np.float32)
    t = rng.choice(u, b, replace=False).astype(np.int32)
    pos_q = rng.randint(0, u, (b, p)).astype(np.int32)
    neg_q = rng.randint(0, u, (b, m)).astype(np.int32)
    return emb, t, pos_q, neg_q


def test_gathered_pair_cosines_match_jax():
    emb, t, pos_q, neg_q = _pair_case(96, 24, 10)

    def jax_loss(e):
        p, n = jax_sddmm.gathered_pair_cosines(e, jnp.asarray(t),
                                               jnp.asarray(pos_q),
                                               jnp.asarray(neg_q))
        return jnp.sum(p ** 2) + jnp.sum(n ** 2)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(emb))
    e = _t(emb).requires_grad_(True)
    p, n = sddmm.gathered_pair_cosines(e, _t(t), _t(pos_q), _t(neg_q))
    got = (p ** 2).sum() + (n ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_grad), **F32)


@pytest.mark.parametrize("u,b,branch", [(2048, 512, "gathered"),
                                        (64, 6, "block")])
def test_pair_loss_scores_branch_and_values(u, b, branch, monkeypatch):
    """The byte-model crossover picks the same branch as the JAX package's,
    and both sides give the same scores."""
    emb, t, pos_q, neg_q = _pair_case(u, 8, b, p=2, m=5)
    calls = []
    block = sddmm.pair_scores
    monkeypatch.setattr(sddmm, "pair_scores",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    got = sddmm.pair_loss_scores(_t(emb), _t(t), _t(pos_q), _t(neg_q))
    assert (len(calls) == 1) == (branch == "block")
    want = jax_sddmm.pair_loss_scores(jnp.asarray(emb), jnp.asarray(t),
                                      jnp.asarray(pos_q), jnp.asarray(neg_q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_pair_cosine_matches_jax():
    emb, t, pos_q, _ = _pair_case(50, 16, 7, seed=2)
    emb[3] = 0.0
    p = np.broadcast_to(t[:, None], pos_q.shape).copy()
    p[0, 0] = 3
    want = jax_agg.pair_cosine(jnp.asarray(emb), jnp.asarray(p),
                               jnp.asarray(pos_q))
    got = agg.pair_cosine(_t(emb), _t(p), _t(pos_q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _pb(seed=5, u=64, h=8, b=6, p=4, m=9):
    rng = np.random.RandomState(seed)
    emb = rng.randn(u, h).astype(np.float32)
    targets = rng.choice(u, b, replace=False).astype(np.int32)
    pos_mask = (rng.rand(b, p) < 0.8).astype(np.float32)
    neg_mask = (rng.rand(b, m) < 0.8).astype(np.float32)
    pos_mask[0] = 0.0     # a node with no positive pair is left out
    pb = {
        "pos_q": rng.randint(0, u, (b, p)).astype(np.int32),
        "pos_mask": pos_mask,
        "neg_q": rng.randint(0, u, (b, m)).astype(np.int32),
        "neg_mask": neg_mask,
        "node_valid": ((pos_mask.sum(1) > 0) & (neg_mask.sum(1) > 0)
                       ).astype(np.float32),
        "target_rows": targets,
    }
    pb["pos_p"] = np.broadcast_to(targets[:, None], (b, p)).copy()
    pb["neg_p"] = np.broadcast_to(targets[:, None], (b, m)).copy()
    return emb, pb


@pytest.mark.parametrize("rows", ["target_rows", "pair_indices"])
@pytest.mark.parametrize("kind", ["normal", "margin"])
def test_unsup_losses_match_jax(kind, rows):
    emb, pb = _pb()
    if rows == "pair_indices":
        del pb["target_rows"]
    else:
        del pb["pos_p"], pb["neg_p"]

    def jax_loss(e):
        return jax_losses.unsup_loss_from_pairbatch(
            e, {k: jnp.asarray(v) for k, v in pb.items()}, kind)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(emb))
    e = _t(emb).requires_grad_(True)
    got = losses.unsup_loss_from_pairbatch(
        e, {k: _t(v) for k, v in pb.items()}, kind)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_grad), **F32)


def test_supervised_nll_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(32, 5).astype(np.float32)
    labels = rng.randint(0, 5, 32).astype(np.int32)
    row_mask = (np.arange(32) < 19).astype(np.float32)

    def jax_loss(x):
        return jax_losses.supervised_nll(jax.nn.log_softmax(x), labels,
                                         row_mask)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = losses.supervised_nll(torch.log_softmax(x, -1), _t(labels),
                                _t(row_mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-7)
    assert not x.grad.numpy()[19:].any()     # padding rows get nothing


def test_unknown_loss_kind_raises():
    emb, pb = _pb()
    with pytest.raises(ValueError, match="margin' or 'normal"):
        losses.unsup_loss_from_pairbatch(_t(emb), {k: _t(v) for k, v in
                                                   pb.items()}, "hinge")


def test_cpu_scores_count_no_launch():
    emb, t = _emb(40, 8), _targets(40, 5)
    before = agg.LAUNCHES["pair_scores"]
    sddmm.PairScores.apply(_t(emb), _t(t))
    sddmm.pair_scores(_t(emb), _t(t))
    assert agg.LAUNCHES["pair_scores"] == before
