"""The port's aggregation ops (graphsage_torch.ops.aggregate) against the JAX
package: its XLA ops (graphsage_tpu.ops.aggregate) and its Pallas kernels
run in interpret mode (graphsage_tpu.ops.pallas_aggregate), on the same
numpy inputs.

On the CPU the public ops run the plain versions; the CUDA kernels are held
against those plain versions by tests/test_torch_kernels.py on the card and
by chip_smoke.py.

Tolerances: float32 rtol=atol=1e-5 (the same sums, taken in another order).
bfloat16 within one bf16 ulp: both sides accumulate in float32 and round
once, so another summation order can move a result across one rounding
boundary at most.  MAX is exact: a max does not depend on order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.ops import aggregate as jax_agg
from graphsage_tpu.ops.pallas_aggregate import (pallas_max_aggregate,
                                                pallas_mean_aggregate)
from graphsage_torch.ops import aggregate as agg
from tests.test_ops import random_case

CASES = {
    "random": dict(u=37, s=11, m=53, d=19),
    "tail600": dict(u=16, s=5, m=64, d=600),
    "unaligned": dict(u=3, s=7, m=11, d=130),
    "empty_rows": dict(u=12, s=6, m=20, d=33),
}

JAX_OPS = {
    "mean": (jax_agg.mean_aggregate, pallas_mean_aggregate,
             agg.mean_aggregate),
    "max": (jax_agg.max_aggregate, pallas_max_aggregate, agg.max_aggregate),
}


def _case(name, seed=0):
    embed, idx, mask = random_case(np.random.RandomState(seed), **CASES[name])
    if name == "empty_rows":
        mask[[0, 5, 11]] = 0.0
    return embed, idx, mask


def _port(fn, embed, idx, mask, dtype=torch.float32):
    out = fn(torch.from_numpy(embed).to(dtype), torch.from_numpy(idx),
             torch.from_numpy(mask))
    return out.float().numpy()


def bf16_ulps(a, b):
    """|a - b| in units of the bf16 spacing at max(|a|, |b|)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    big = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 2.0**-126))) - 7)
    return np.abs(a - b) / ulp


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["mean", "max"])
def test_plain_matches_jax_f32(kind, case):
    embed, idx, mask = _case(case)
    xla_fn, pallas_fn, port_fn = JAX_OPS[kind]
    e, i, m = jnp.asarray(embed), jnp.asarray(idx), jnp.asarray(mask)
    got = _port(port_fn, embed, idx, mask)
    np.testing.assert_allclose(got, np.asarray(xla_fn(e, i, m)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(pallas_fn(e, i, m, interpret=True)),
        rtol=1e-5, atol=1e-5)
    if case == "empty_rows":
        assert not got[[0, 5, 11]].any()
    if case == "tail600":  # the columns past the first 512-wide TPU tile
        np.testing.assert_allclose(got[:, 512:],
                                   np.asarray(xla_fn(e, i, m))[:, 512:],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mean", "max"])
def test_plain_matches_jax_bf16(kind):
    embed, idx, mask = _case("random", seed=1)
    xla_fn, pallas_fn, port_fn = JAX_OPS[kind]
    e = jnp.asarray(embed, dtype=jnp.bfloat16)
    i, m = jnp.asarray(idx), jnp.asarray(mask)
    got = _port(port_fn, np.array(e.astype(jnp.float32)), idx, mask,
                dtype=torch.bfloat16)
    for want in (xla_fn(e, i, m), pallas_fn(e, i, m, interpret=True)):
        want = np.asarray(want.astype(jnp.float32))
        if kind == "max":
            np.testing.assert_array_equal(got, want)
        else:
            assert bf16_ulps(got, want).max() <= 1.0


def test_sum_plain_matches_jax():
    embed, idx, mask = _case("random", seed=2)
    got = _port(agg.sum_aggregate_plain, embed, idx, mask)
    want = jax_agg.sum_aggregate(jnp.asarray(embed), jnp.asarray(idx),
                                 jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_strided_embed_view():
    """MEAN serving aggregates z[:, H:], a view with row stride 2H."""
    embed, idx, mask = _case("random", seed=3)
    wide = np.concatenate([np.ones_like(embed), embed], axis=1)
    view = torch.from_numpy(wide)[:, embed.shape[1]:]
    assert view.stride() == (2 * embed.shape[1], 1)
    got = agg.mean_aggregate(view, torch.from_numpy(idx),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        got, _port(agg.mean_aggregate, embed, idx, mask))


@pytest.mark.parametrize("kind", ["mean", "max"])
def test_plain_grad_matches_jax(kind):
    """The plain versions are differentiable on the CPU; their gradient
    agrees with JAX's (no tied maxima in random_case's data)."""
    embed, idx, mask = _case("random", seed=4)
    xla_fn, _, port_fn = JAX_OPS[kind]
    i, m = jnp.asarray(idx), jnp.asarray(mask)
    want = jax.grad(lambda e: jnp.sum(jnp.sin(xla_fn(e, i, m))))(
        jnp.asarray(embed))
    e = torch.from_numpy(embed).requires_grad_(True)
    torch.sin(port_fn(e, torch.from_numpy(idx),
                      torch.from_numpy(mask))).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
