"""The port's checkpoints (graphsage_torch.utils.checkpoint) on the CPU:
the round trip, resume equal to the unbroken run bit for bit (compact sup,
cached sup MEAN in float32 and bfloat16), the RandomState arrays against the
JAX package's, and a JAX checkpoint resumed by both packages' Trainer.

Tolerances: the round trip and the resumes are exact.  The parity case
resumes one epoch (10 steps, lr 0.7) from the same restored state in both
packages: step losses and params rtol 1e-5 (atol 1e-6), float32 roundings
of the same arithmetic in another order.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.models import GraphSageConfig as JaxConfig
from graphsage_tpu.train import Trainer as JaxTrainer
from graphsage_tpu.train import TrainConfig as JaxTrainConfig
from graphsage_tpu.utils import checkpoint as jax_checkpoint
from graphsage_torch.convert import flatten_params, params_to_numpy
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.train import CachedTrainer, Trainer, TrainConfig
from graphsage_torch.train.trainer import _leaf_params
from graphsage_torch.utils.checkpoint import (GeneratorState,
                                              _rng_state_to_tree,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              set_generator_state)


def _params(seed: int, cfg: GraphSageConfig, classes: int = 3) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"sage": init_graphsage(gen, cfg),
            "clf": init_classifier(gen, cfg.out_size, classes)}


def _assert_params_equal(a, b):
    fa, fb = flatten_params(params_to_numpy(a)), flatten_params(
        params_to_numpy(b))
    assert fa.keys() == fb.keys()
    for key in fa:
        np.testing.assert_array_equal(fb[key], fa[key], err_msg=key)


def test_checkpoint_roundtrip(tmp_path):
    cfg = GraphSageConfig(num_layers=2, input_size=8, out_size=4)
    params = _params(0, cfg)
    rng = np.random.RandomState(7)
    rng.rand(100)
    rng.randn()                 # a cached gaussian is part of the state
    expected_next = np.random.RandomState()
    expected_next.set_state(rng.get_state())
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    gen_next = torch.Generator()
    gen_next.set_state(gen.get_state())

    path = str(tmp_path / "ck")
    save_checkpoint(path, params, epoch=12, max_vali_f1=0.77, rng=rng,
                    generator=gen, test_f1=0.5)
    assert sorted(os.listdir(tmp_path)) == ["ck"]   # no temporary left
    r_params, r_epoch, r_best, r_rng, r_gen = restore_checkpoint(
        path, _params(1, cfg), with_generator_state=True)
    assert r_epoch == 12 and r_best == 0.77
    _assert_params_equal(params, r_params)
    np.testing.assert_array_equal(r_rng.rand(5), expected_next.rand(5))
    assert r_rng.randn() == expected_next.randn()
    assert r_gen.device == "cpu"
    fresh = torch.Generator().manual_seed(0)
    set_generator_state(fresh, r_gen)
    assert torch.equal(torch.rand(7, generator=fresh),
                       torch.rand(7, generator=gen_next))
    # the four-element API, and numpy alone reads the file
    assert len(restore_checkpoint(path, params)) == 4
    with np.load(path, allow_pickle=False) as z:
        assert "params/sage/layers/0/weight" in z.files


def test_restore_refuses_another_model(tmp_path):
    cfg = GraphSageConfig(num_layers=2, input_size=8, out_size=4)
    path = str(tmp_path / "ck")
    save_checkpoint(path, _params(0, cfg), 0, 0.5,
                    np.random.RandomState(0))
    other = GraphSageConfig(num_layers=2, input_size=8, out_size=6)
    with pytest.raises(ValueError, match="holds params"):
        restore_checkpoint(path, _params(0, other))


def test_rng_arrays_match_jax():
    rng = np.random.RandomState(3)
    rng.rand(17)
    rng.randn()
    want = jax_checkpoint._rng_state_to_tree(rng.get_state())
    got = _rng_state_to_tree(rng.get_state())
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_checkpoint_without_generator_state_restores(tmp_path):
    cfg = GraphSageConfig(num_layers=1, input_size=4, out_size=4)
    path = str(tmp_path / "ck")
    save_checkpoint(path, _params(0, cfg, 2), epoch=3, max_vali_f1=0.5,
                    rng=np.random.RandomState(1))
    _, epoch, best, _, gen = restore_checkpoint(path, _params(0, cfg, 2),
                                                with_generator_state=True)
    assert gen is None and epoch == 3 and best == 0.5


class _CardGenerator:
    """Stands in for a CUDA generator where there is no card."""
    device = torch.device("cuda")

    def set_state(self, state):
        raise AssertionError("a cross-device state must not be loaded")


@pytest.mark.parametrize("saved_on,target", [
    ("cuda", torch.Generator()), ("cpu", _CardGenerator())],
    ids=["cuda_into_cpu", "cpu_into_cuda"])
def test_generator_state_from_another_device_raises(saved_on, target):
    saved = GeneratorState(torch.Generator().get_state(), saved_on)
    with pytest.raises(ValueError, match=f"from a {saved_on} generator.*"
                                         f"{target.device.type}"):
        set_generator_state(target, saved)


@pytest.fixture(scope="module")
def small():
    return synthetic_power_law(120, 500, num_feats=8, num_classes=3, seed=1)


def test_resume_continues_from_checkpointed_epoch(small, tmp_path):
    mcfg = GraphSageConfig(num_layers=1, input_size=8, out_size=8)
    tr = Trainer(small, mcfg, TrainConfig(learn_method="sup", epochs=2,
                                          b_sz=32, seed=3, verbose=False),
                 device="cpu")
    tr.fit()
    assert tr.epoch == 1
    path = str(tmp_path / "ck")
    save_checkpoint(path, tr.params, tr.epoch, tr.max_vali_f1, tr.rng)

    tr2 = Trainer(small, mcfg, TrainConfig(learn_method="sup", epochs=4,
                                           b_sz=32, seed=3, verbose=False),
                  device="cpu")
    params, epoch, best, rng = restore_checkpoint(path, tr2.params)
    tr2.params = _leaf_params(params, tr2.device)
    tr2.epoch, tr2.max_vali_f1, tr2.rng = epoch + 1, best, rng
    tr2.fit()
    assert [h["epoch"] for h in tr2.history] == [2, 3]


def _make(pipeline: str, ds, dtype: str, extend: bool = True):
    mcfg = GraphSageConfig(num_layers=2, input_size=ds.feature_dim,
                           out_size=8, compute_dtype=dtype)
    tcfg = TrainConfig(learn_method="sup", epochs=3, b_sz=32, seed=3,
                       verbose=False)
    if pipeline == "cached":
        return CachedTrainer(ds, mcfg, tcfg, table_cap=8,
                             extend_batches=extend, device="cpu")
    return Trainer(ds, mcfg, tcfg, device="cpu")


@pytest.mark.parametrize("pipeline,dtype,extend", [
    ("compact", "float32", True), ("cached", "float32", True),
    ("cached", "bfloat16", True), ("cached", "bfloat16", False)])
def test_resume_matches_unbroken_run(small, tmp_path, pipeline, dtype,
                                     extend):
    """Checkpoint after epoch 0, then epochs 1-2 unbroken and resumed in a
    fresh trainer: the same losses and params, bit for bit (cached:
    extended batches, and the plain batches of --no_extend)."""
    tr_a = _make(pipeline, small, dtype, extend)
    tr_a.train_epoch()
    tr_a.evaluate()
    path = str(tmp_path / "ck")
    gen = getattr(getattr(tr_a, "hop", None), "generator", None)
    save_checkpoint(path, tr_a.params, 0, tr_a.max_vali_f1, tr_a.rng,
                    generator=gen)
    unbroken = []
    for epoch in (1, 2):
        tr_a.epoch = epoch
        unbroken.append(tr_a.train_epoch())
        tr_a.evaluate()

    tr_b = _make(pipeline, small, dtype, extend)
    params, epoch, best, rng, saved = restore_checkpoint(
        path, tr_b.params, with_generator_state=True)
    assert (saved is None) == (pipeline == "compact")
    if saved is not None:
        set_generator_state(tr_b.hop.generator, saved)
    tr_b.params = _leaf_params(params, tr_b.device)
    tr_b.max_vali_f1, tr_b.rng = best, rng
    resumed = []
    for epoch in (epoch + 1, epoch + 2):
        tr_b.epoch = epoch
        resumed.append(tr_b.train_epoch())
        tr_b.evaluate()
    assert resumed == unbroken
    assert tr_b.step_losses == tr_a.step_losses
    assert tr_b.history == tr_a.history[1:]
    _assert_params_equal(tr_a.params, tr_b.params)


@pytest.fixture(scope="module")
def parity_data():
    """synthetic_power_law(2000, 10000, 64 features) from both packages,
    the train split cut to its first 200 nodes (10 steps of 20)."""
    jds = jax_power_law(2000, 10000, num_feats=64, seed=1)
    ds = synthetic_power_law(2000, 10000, num_feats=64, seed=1)
    return (dataclasses.replace(ds, train_nodes=ds.train_nodes[:200]),
            dataclasses.replace(jds, train_nodes=jds.train_nodes[:200]))


def test_jax_checkpoint_resumes_alike_in_both_packages(parity_data,
                                                       tmp_path):
    """A JAX compact sup Trainer checkpointed by the JAX package after
    epoch 0 and restored by it, then resumed for epoch 1 by the JAX and the
    port Trainer: the same host batches, losses and params within rtol
    1e-5."""
    ds, jds = parity_data
    jm = JaxConfig(num_layers=2, input_size=64, out_size=16)
    jt = JaxTrainConfig(learn_method="sup", epochs=2, b_sz=20, seed=5,
                        verbose=False)
    jtr = JaxTrainer(jds, jm, jt)
    jtr.train_epoch()
    jtr.evaluate()
    path = str(tmp_path / "jax_ck")
    jax_checkpoint.save_checkpoint(path, jtr.params, 0, jtr.max_vali_f1,
                                   jtr.rng)

    jtr_b = JaxTrainer(jds, jm, jt)
    params, epoch, best, rng = jax_checkpoint.restore_checkpoint(
        path, jtr_b.params)
    port_rng = np.random.RandomState()
    port_rng.set_state(rng.get_state())
    jtr_b.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jtr_b.epoch, jtr_b.max_vali_f1, jtr_b.rng = epoch + 1, best, rng
    jax_losses = []
    step = jtr_b._step_fn

    def recording_step(*args):
        out = step(*args)
        jax_losses.append(float(out[1]))
        return out

    jtr_b._step_fn = recording_step
    jtr_b.train_epoch()

    tr = Trainer(ds, GraphSageConfig(**dataclasses.asdict(jm)),
                 TrainConfig(learn_method="sup", epochs=2, b_sz=20, seed=5,
                             verbose=False),
                 params=params, device="cpu")
    tr.epoch, tr.max_vali_f1, tr.rng = epoch + 1, best, port_rng
    tr.train_epoch()
    assert len(tr.step_losses) == len(jax_losses) == 10
    np.testing.assert_allclose(tr.step_losses, jax_losses, rtol=1e-5)
    want = flatten_params(jax.device_get(jtr_b.params))
    got = flatten_params(params_to_numpy(tr.params))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert tr.rng.randint(2**31) == jtr_b.rng.randint(2**31)
