"""Process-group initialization for the distributed pipelines.

Port of ``graphsage_tpu/parallel/multihost.py``.  ``torch.distributed`` runs
one process a rank: under ``torchrun`` each process finds its rank and the
rendezvous in its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), and :func:`initialize` forms the group
from it.

- On the card the backend is NCCL, each process on the card
  ``LOCAL_RANK`` names (``torch.cuda.set_device``); gloo runs only where
  the caller asks for the CPU.  A CUDA run never falls back to gloo.
- With no job named in the environment, the group is a world of 1 over an
  in-memory store (``HashStore``): the same collectives run, on one rank.
- Where the environment names a multi-process job (``WORLD_SIZE`` > 1) and
  the group cannot be formed (no rendezvous address, a peer that never
  comes), it raises ``RuntimeError``: a job must not degrade silently
  into independent world-1 runs that each train the same rows (the JAX
  package's contract, ``multihost.py:56-84``).

Every group is formed with a ``timeout``, so that a missing peer raises
instead of hanging, and a collective that waits longer than it raises too
(``GS_DIST_TIMEOUT_S``, default 300 s).

Every rank builds the same global host arrays from the shared seed and
takes its own row (:func:`local_batch_rows`), as ``put_global`` assumes
in the JAX package.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def _timeout(timeout_s: float | None) -> datetime.timedelta:
    if timeout_s is None:
        timeout_s = float(os.environ.get("GS_DIST_TIMEOUT_S", "300"))
    return datetime.timedelta(seconds=timeout_s)


def initialize(device: str | torch.device | None = None,
               timeout_s: float | None = None) -> torch.device:
    """Form the default process group (once; later calls return at once)
    and return the device this rank runs on: ``cuda:LOCAL_RANK`` unless
    ``device`` names the CPU.  ``device=None`` means the card."""
    want_cpu = device is not None and torch.device(device).type == "cpu"
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = (torch.device("cpu") if want_cpu
           else torch.device("cuda", local_rank))
    if dist.is_initialized():
        return dev
    if not want_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the distributed pipelines run NCCL on the "
                "card; pass device='cpu' (--device cpu) for gloo on the CPU")
        torch.cuda.set_device(dev)
    backend = "gloo" if want_cpu else "nccl"
    world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    named = all(os.environ.get(k) for k in ("RANK", "MASTER_ADDR",
                                            "MASTER_PORT"))
    if world > 1 and not named:
        raise RuntimeError(
            f"WORLD_SIZE={world} names a multi-process job, but RANK, "
            f"MASTER_ADDR and MASTER_PORT do not all say where it meets; "
            f"refusing to run as world 1 (launch with torchrun)")
    try:
        if named:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=_timeout(timeout_s))
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1,
                                    timeout=_timeout(timeout_s))
    except (RuntimeError, ValueError, OSError) as e:
        if world > 1:
            raise RuntimeError(
                f"could not form the {world}-process group named by the "
                f"environment ({backend}): {e}; refusing to run as world "
                f"1") from e
        raise
    return dev


def shutdown() -> None:
    """Tear the default group down, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_rows(global_batch: np.ndarray, group=None) -> np.ndarray:
    """This rank's row of a [world, ...] host-built batch: the JAX package
    feeds each process its addressable shards, and a process here holds
    one."""
    return global_batch[dist.get_rank(group)]
