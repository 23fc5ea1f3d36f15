"""Edge-partitioned feature storage with a fixed-shape halo exchange.

Port of ``graphsage_tpu/parallel/halo.py``.  Nodes are partitioned into
contiguous ranges, the feature table is sharded row-wise over the ranks,
and each rank trains on its own batch shard.  Frontier gathers then need
rows owned by peers, the halo, which two all_to_alls bring:

1. the *request tables* (int32 [P, cap]), so that every owner learns which
   of its rows each peer needs;
2. every owner gathers the requested rows from its local shard and sends
   the payload [P, cap, D] back.

The requester then takes its frontier rows out of the received buffer.
Host-side planning (``plan_halo``) is numpy, a copy of the JAX package's,
bit-identical; the exchange (``halo_gather_local``) runs one rank's part
with the collectives of ``parallel/comm.py``.  Every row gather of the
exchange (serving the requests, taking rows out of the received buffer,
the local rows) is the ``gather_rows`` kernel on the card, whose backward
is ``ops.scatter.scatter_rows`` (the ``scatter_rows`` kernel in bfloat16,
``index_add_`` in float32); the payload's all_to_all is differentiable, so
gradients flow back to the owner's rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphsage_torch.ops.gather import gather_rows
from graphsage_torch.parallel import comm


def partition_bounds(num_nodes: int, n_dev: int) -> int:
    """Rows per shard (contiguous ranges; the last shard padded)."""
    return (num_nodes + n_dev - 1) // n_dev


def shard_features(feats: np.ndarray, n_dev: int) -> np.ndarray:
    """Pad the feature table to n_dev equal contiguous row shards:
    [n_dev * rows_per, D]."""
    rows_per = partition_bounds(feats.shape[0], n_dev)
    out = np.zeros((n_dev * rows_per, feats.shape[1]), feats.dtype)
    out[:feats.shape[0]] = feats
    return out


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Per-batch exchange plan (host-built, device-consumed).

    requests:      int32 [n_dev, n_dev, cap]: requests[r, o, :] are
                   OWNER-LOCAL row ids device r needs from device o (pad
                   slots 0).
    addr_owner:    int32 [n_dev, b_loc]: owner of each frontier slot.
    addr_slot:     int32 [n_dev, b_loc]: slot in the received [n_dev, cap]
                   buffer for each frontier slot.
    addr_is_local: float32 [n_dev, b_loc]: 1 where the slot's row is the
                   requester's own (with ``exclude_self``, such slots
                   bypass the exchange: requests[r, r] stays empty).
    addr_local:    int32 [n_dev, b_loc]: the local row of those slots.
    """
    requests: np.ndarray
    addr_owner: np.ndarray
    addr_slot: np.ndarray
    addr_is_local: np.ndarray
    addr_local: np.ndarray
    cap: int
    rows_per: int


def _bucket_cap(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def plan_halo(ids_per_dev: np.ndarray, num_nodes: int, n_dev: int,
              cap: int | None = None,
              exclude_self: bool = True) -> HaloPlan:
    """Build the exchange plan for per-device frontier id lists.

    ids_per_dev: int [n_dev, b_loc] global node ids each device needs
    (duplicates collapse to one request slot)."""
    ids_per_dev = np.asarray(ids_per_dev)
    n_dev_in, b_loc = ids_per_dev.shape
    assert n_dev_in == n_dev
    rows_per = partition_bounds(num_nodes, n_dev)

    owners = (ids_per_dev // rows_per).astype(np.int64)  # [n_dev, b_loc]
    local_rows = (ids_per_dev % rows_per).astype(np.int64)

    me = np.arange(n_dev)[:, None]
    addr_is_local = ((owners == me) & exclude_self)
    addr_local = np.where(addr_is_local, local_rows, 0).astype(np.int32)
    addr_owner = owners.astype(np.int32)
    addr_slot = np.zeros((n_dev, b_loc), np.int32)

    # One global sort instead of an n_dev² loop: the composite key
    # (requester, owner, local_row) is unique'd once, and since np.unique
    # returns sorted keys, a (requester, owner) group is contiguous, so
    # slot numbers are a subtraction against the group's start.
    requester = np.broadcast_to(np.arange(n_dev)[:, None],
                                owners.shape).astype(np.int64)
    key = (requester * n_dev + owners) * rows_per + local_rows
    sel = ~addr_is_local.reshape(-1)             # slots that go over the wire
    uniq, inv = np.unique(key.reshape(-1)[sel], return_inverse=True)
    group = uniq // rows_per                     # requester * n_dev + owner
    l_u = (uniq % rows_per).astype(np.int32)
    grp_ids, grp_start, grp_counts = np.unique(
        group, return_index=True, return_counts=True)
    start_of = np.zeros(n_dev * n_dev, np.int64)
    start_of[grp_ids] = grp_start
    slot_in_grp = (np.arange(len(uniq)) - start_of[group]).astype(np.int32)

    max_cap = int(grp_counts.max()) if len(grp_counts) else 1
    if cap is None:
        cap = _bucket_cap(max_cap)
    assert cap >= max_cap, (cap, max_cap)

    requests = np.zeros((n_dev, n_dev, cap), dtype=np.int32)
    requests[group // n_dev, group % n_dev, slot_in_grp] = l_u
    addr_slot.reshape(-1)[sel] = slot_in_grp[inv]
    return HaloPlan(requests=requests, addr_owner=addr_owner,
                    addr_slot=addr_slot,
                    addr_is_local=addr_is_local.astype(np.float32),
                    addr_local=addr_local, cap=cap, rows_per=rows_per)


def halo_gather_local(feats_local: torch.Tensor, requests: torch.Tensor,
                      addr_owner: torch.Tensor, addr_slot: torch.Tensor,
                      addr_is_local: torch.Tensor | None = None,
                      addr_local: torch.Tensor | None = None,
                      group=None) -> torch.Tensor:
    """One rank's part of the exchange: [b_loc, D] rows for its frontier
    slots (``graphsage_tpu/parallel/halo.py:141-171``).

    feats_local:  [rows_per, D] this rank's rows (float32 or bfloat16).
    requests:     int32 [P, cap] owner-local rows this rank requests of
                  each owner; addr_owner / addr_slot / addr_local int32
                  [b_loc]; addr_is_local [b_loc] (nonzero: a local slot,
                  read from feats_local directly)."""
    # 1. the request tables: row q of the result is what rank q wants
    #    from this rank
    to_serve = comm.all_to_all_rows(requests.int(), group)    # [P, cap]
    p, cap = to_serve.shape
    # 2. serve from the local shard and send the payloads back
    served = gather_rows(feats_local, to_serve.reshape(-1))   # [P*cap, D]
    recv = comm.all_to_all_rows(served.reshape(p, cap, -1), group)
    # 3. take this rank's rows out of the received [P*cap, D] buffer
    flat = recv.reshape(p * cap, -1)
    remote = gather_rows(flat, (addr_owner * cap + addr_slot).int())
    if addr_is_local is None:
        return remote
    local = gather_rows(feats_local, addr_local.int().contiguous())
    return torch.where(addr_is_local[:, None] > 0, local, remote)


def make_halo_gather(group=None):
    """``make_halo_gather`` of the JAX package as a per-rank function:
    (feats_local, requests [P, cap], addr_owner, addr_slot, addr_is_local,
    addr_local) -> [b_loc, D], this rank's rows."""
    def gather(feats_local, requests, addr_owner, addr_slot, addr_is_local,
               addr_local):
        return halo_gather_local(feats_local, requests, addr_owner,
                                 addr_slot, addr_is_local, addr_local, group)

    return gather
