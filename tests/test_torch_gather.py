"""The row gather (graphsage_torch.ops.gather) against the JAX package's
``jnp.take(table, idx, axis=0)``, on the CPU: what
``tools/pallas_microbench.py`` asserts of its Pallas ``gather_kernel``
(which is a closure inside that tool's ``main`` and cannot be imported),
and the gradient against ``jax.vjp`` of ``jnp.take``.

Tolerances: the forward is a copy, so exact; the gradient sums duplicate
rows in another order, rtol=atol=1e-6.  The kernel itself runs on the
card (tests/test_torch_kernels.py, ``gpu``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_torch.ops import aggregate as agg
from graphsage_torch.ops import gather


def _case(m, d, j, seed=0):
    rng = np.random.RandomState(seed)
    table = rng.randn(m, d).astype(np.float32)
    idx = rng.randint(0, m, j).astype(np.int32)
    if j:
        idx[:3] = idx[0]                             # duplicate rows
    return table, idx


@pytest.mark.parametrize("m,d,j", [(100, 128, 4096), (53, 602, 77),
                                   (7, 3, 0)], ids=["microbench_width",
                                                    "feature_width", "empty"])
def test_plain_equals_jnp_take_and_counts_nothing(m, d, j):
    table, idx = _case(m, d, j)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    before = dict(agg.LAUNCHES)
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert agg.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.gather_rows_plain(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("m,d,j", [(100, 16, 500), (5, 9, 40)])
def test_gradient_equals_jax_vjp_of_take(m, d, j):
    table, idx = _case(m, d, j, seed=1)
    g = np.random.RandomState(2).randn(j, d).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                     jnp.asarray(table))
    want, = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    (gather.gather_rows(t, torch.from_numpy(idx)) * torch.from_numpy(g)
     ).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # through a strided view of a wider table, the other columns get none
    wide = torch.from_numpy(np.concatenate([table, table], axis=1)
                            ).requires_grad_(True)
    (gather.gather_rows(wide[:, d:], torch.from_numpy(idx))
     * torch.from_numpy(g)).sum().backward()
    assert not wide.grad[:, :d].any()
    np.testing.assert_array_equal(wide.grad[:, d:].numpy(), t.grad.numpy())
