"""The port's halo exchange (graphsage_torch.parallel.halo) against the JAX
package's (graphsage_tpu.parallel.halo), on the CPU.

- Host planning (``plan_halo``, ``shard_features``, ``partition_bounds``,
  ``_bucket_cap``): bit-identical arrays.
- ``halo_gather_local`` on P gloo ranks (tests/torch_dist_worker.py) against
  the JAX package's ``make_halo_gather`` under ``shard_map`` on the first P
  virtual CPU devices, for P in {1, 2, 4}: the forward rows, and the
  gradient of sum(out * cot) with respect to the sharded table through the
  transposed all_to_all.  float32 and bfloat16 are exact: the forward is
  row copies, and the gradient adds the same cotangent rows into each
  table row in index order on both sides (``scatter_rows`` in bfloat16,
  JAX's order; at most a handful of float32 terms a row, the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphsage_tpu.parallel import halo as jh
from graphsage_torch.parallel import halo
from tests.torch_dist_worker import run_ranks

NUM_NODES, D, B_LOC = 103, 16, 24   # 103 is not a multiple of P


def _ids(world, seed=0, dups=False):
    rng = np.random.RandomState(seed)
    if dups:
        return np.tile(rng.randint(0, NUM_NODES, (world, 4)), (1, 6))
    return rng.randint(0, NUM_NODES, (world, B_LOC))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("dups", [False, True])
def test_plan_halo_equals_jax(world, exclude_self, dups):
    ids = _ids(world, seed=world, dups=dups)
    got = halo.plan_halo(ids, NUM_NODES, world, exclude_self=exclude_self)
    want = jh.plan_halo(ids, NUM_NODES, world, exclude_self=exclude_self)
    for field in ("requests", "addr_owner", "addr_slot", "addr_is_local",
                  "addr_local"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.cap, got.rows_per) == (want.cap, want.rows_per)
    fixed = halo.plan_halo(ids, NUM_NODES, world, cap=64)
    np.testing.assert_array_equal(
        fixed.requests, jh.plan_halo(ids, NUM_NODES, world, cap=64).requests)


def test_shard_features_and_bounds_equal_jax():
    feats = np.random.RandomState(1).randn(NUM_NODES, D).astype(np.float32)
    for world in (1, 3, 4, 8):
        assert (halo.partition_bounds(NUM_NODES, world)
                == jh.partition_bounds(NUM_NODES, world))
        np.testing.assert_array_equal(halo.shard_features(feats, world),
                                      jh.shard_features(feats, world))
    for n in (0, 1, 16, 17, 1000):
        assert halo._bucket_cap(n) == jh._bucket_cap(n)


def _jax_halo(world, feats_sh, plan, cot, dtype):
    """The JAX package's exchange under shard_map: (out [P, b, D], the
    gradient of sum(out * cot) w.r.t. the sharded table)."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data",))
    gather = jh.make_halo_gather(mesh)
    put = lambda a, spec: jax.device_put(jnp.asarray(a),
                                         NamedSharding(mesh, spec))
    args = (put(plan.requests, P("data", None, None)),
            put(plan.addr_owner, P("data", None)),
            put(plan.addr_slot, P("data", None)),
            put(plan.addr_is_local, P("data", None)),
            put(plan.addr_local, P("data", None)))
    table = put(jnp.asarray(feats_sh, dtype=dtype), P("data", None))

    def loss(t):
        out = gather(t, *args)
        return jnp.sum(out.astype(jnp.float32) * cot.reshape(out.shape)), out

    grad, out = jax.jit(jax.grad(loss, has_aux=True))(table)
    b = cot.shape[1]
    return (np.asarray(out.astype(jnp.float32)).reshape(world, b, -1),
            np.asarray(grad.astype(jnp.float32)))


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def exchanged(request):
    world = request.param
    rng = np.random.RandomState(10 + world)
    feats = rng.randn(NUM_NODES, D).astype(np.float32)
    feats_sh = halo.shard_features(feats, world)
    cases = {}
    for name, dtype, dups in (("float32", "float32", False),
                              ("bfloat16", "bfloat16", False),
                              ("dups", "float32", True)):
        ids = _ids(world, seed=world + 20, dups=dups)
        plan = halo.plan_halo(ids, NUM_NODES, world)
        cot = rng.randn(world, ids.shape[1], D).astype(np.float32)
        cases[name] = dict(ids=ids, plan=plan, cot=cot, dtype=dtype,
                           feats=feats_sh)
    jobs = [(name, "halo", {"feats": c["feats"], "dtype": c["dtype"],
                            "cot": c["cot"],
                            "plan": {k: getattr(c["plan"], k) for k in (
                                "requests", "addr_owner", "addr_slot",
                                "addr_is_local", "addr_local")}})
            for name, c in cases.items()]
    out = run_ranks(jobs, world)
    return world, cases, out, feats


@pytest.mark.parametrize("case", ["float32", "bfloat16", "dups"])
def test_halo_gather_local_matches_jax(exchanged, case):
    world, cases, out, feats = exchanged
    c = cases[case]
    dtype = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    want_out, want_grad = _jax_halo(world, c["feats"], c["plan"], c["cot"],
                                    dtype)
    rows_per = c["feats"].shape[0] // world
    for r in range(world):
        got = out[r][case]
        np.testing.assert_array_equal(got["out"], want_out[r])
        np.testing.assert_array_equal(
            got["grad"], want_grad[r * rows_per:(r + 1) * rows_per])
    if c["dtype"] == "float32":
        # the exchange gathers the rows the plan asked for
        np.testing.assert_array_equal(
            np.stack([out[r][case]["out"] for r in range(world)]),
            feats[c["ids"]])
