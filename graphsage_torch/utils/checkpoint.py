"""Checkpoints on disk: save and resume.

Port of ``graphsage_tpu/utils/checkpoint.py`` without orbax (it imports
JAX).  A checkpoint is one ``.npz`` file written with ``allow_pickle=False``,
so numpy alone loads it:

- ``params/<path>``: the float32 master params, one array per pytree path
  (``convert.flatten_params``);
- ``epoch``, ``max_vali_f1`` and ``test_f1`` (the test F1 of the epoch the
  checkpoint was written in);
- ``rng/keys|pos|has_gauss|cached_gaussian``: the numpy ``RandomState`` that
  drives the host sampling, walks, negatives and shuffles, as the JAX
  package's four arrays (``_rng_state_to_tree``);
- for the cached pipeline, in place of the JAX package's device PRNG key,
  ``generator/state`` and ``generator/device``: the state of the device
  sampler's ``torch.Generator`` (a uint8 tensor) and its device type.

The file is written under a temporary name that does not start with
``model_best_``, synced, and renamed into place, so a process that dies in
the middle of a write never leaves a torn file that the supervisor's
newest-checkpoint rule would pick.

Exactness, as in the JAX package: supervised runs resume exactly (the
compact and the cached pipeline), with one exception: under
``refresh_every`` k > 1 a resume draws the leaf cache afresh at the resumed
epoch instead of reusing the stale cache of the last refresh epoch, which
is not saved; the refresh schedule realigns at the next multiple of k.
unsup and plus_unsup runs resume correctly but not exactly: the checkpoint
is written in the middle of ``train_classification`` (on val improvement),
after which the unbroken run goes on drawing from the host RNG (the
classifier's batch order) and, with ``strict_clf_eval``, from the device
generator; a resume starts at the next epoch from the state of that
moment.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from graphsage_torch.convert import (flatten_params, params_to_numpy,
                                     unflatten_params)


class GeneratorState(NamedTuple):
    """A ``torch.Generator``'s state and the device type it draws on."""
    state: torch.Tensor
    device: str


def _rng_state_to_tree(state: tuple) -> dict:
    # state[0] is always the algorithm name 'MT19937' for RandomState
    _name, keys, pos, has_gauss, cached = state
    return {
        "keys": np.asarray(keys, dtype=np.uint32),
        "pos": np.asarray([pos], dtype=np.int64),
        "has_gauss": np.asarray([has_gauss], dtype=np.int64),
        "cached_gaussian": np.asarray([cached], dtype=np.float64),
    }


def _tree_to_rng_state(tree: dict) -> tuple:
    return ("MT19937", np.asarray(tree["keys"], dtype=np.uint32),
            int(tree["pos"][0]), int(tree["has_gauss"][0]),
            float(tree["cached_gaussian"][0]))


def save_checkpoint(path: str, params, epoch: int, max_vali_f1: float,
                    rng: np.random.RandomState,
                    generator: torch.Generator | None = None,
                    test_f1: float | None = None) -> None:
    """``params``: the {"sage", "clf"} pytree (tensors on any device or
    numpy arrays).  ``generator`` (optional): the device sampler's
    generator (``CachedTrainer.hop.generator``), whose state makes the
    cached pipeline's resume exact."""
    arrays = {f"params/{k}": v for k, v in
              flatten_params(params_to_numpy(params)).items()}
    arrays["epoch"] = np.asarray([epoch], dtype=np.int64)
    arrays["max_vali_f1"] = np.asarray([max_vali_f1], dtype=np.float64)
    arrays["test_f1"] = np.asarray(
        [np.nan if test_f1 is None else test_f1], dtype=np.float64)
    for k, v in _rng_state_to_tree(rng.get_state()).items():
        arrays[f"rng/{k}"] = v
    if generator is not None:
        arrays["generator/state"] = generator.get_state().numpy()
        arrays["generator/device"] = np.asarray(generator.device.type)
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory,
                       f".tmp-{os.getpid()}-{os.path.basename(path)}")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_checkpoint(path: str, params_like,
                       with_generator_state: bool = False):
    """Restore (params, epoch, max_vali_f1, rng), plus the saved
    :class:`GeneratorState` (or None, for a checkpoint written without
    one) as a fifth element when ``with_generator_state`` is true.

    ``params`` is a pytree of float32 numpy arrays with the layout of
    ``params_like`` (e.g. a fresh trainer's params); a checkpoint of
    another model raises ``ValueError``."""
    with np.load(os.path.abspath(path), allow_pickle=False) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
        epoch = int(z["epoch"][0])
        best = float(z["max_vali_f1"][0])
        rng_tree = {k: z[f"rng/{k}"] for k in
                    ("keys", "pos", "has_gauss", "cached_gaussian")}
        gen = None
        if "generator/state" in z.files:
            gen = GeneratorState(
                torch.from_numpy(z["generator/state"].copy()),
                str(z["generator/device"]))
    want = {k: tuple(v.shape) for k, v in flatten_params(params_like).items()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if got != want:
        raise ValueError(f"checkpoint {path} holds params {got}, the model "
                         f"has {want}")
    rng = np.random.RandomState(0)
    rng.set_state(_tree_to_rng_state(rng_tree))
    out = (unflatten_params(flat), epoch, best, rng)
    return out + (gen,) if with_generator_state else out


def checkpoint_test_f1(path: str) -> float | None:
    """The test F1 recorded with a checkpoint (None if it has none)."""
    with np.load(os.path.abspath(path), allow_pickle=False) as z:
        value = float(z["test_f1"][0]) if "test_f1" in z.files else np.nan
    return None if np.isnan(value) else value


def set_generator_state(generator: torch.Generator,
                        saved: GeneratorState) -> None:
    """Load a saved state into ``generator``.  A state from another device
    type raises ``ValueError``: a CPU and a CUDA generator draw different
    streams, so such a resume could not be exact."""
    if saved.device != generator.device.type:
        raise ValueError(
            f"the checkpoint's sampler state is from a {saved.device} "
            f"generator, this run's sampler draws on {generator.device.type}"
            f": the two streams differ, so the resume could not be exact")
    generator.set_state(saved.state)
