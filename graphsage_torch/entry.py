"""The flagship forward at tiny shapes, as a callable and its arguments.

Port of ``entry()`` in ``__graft_entry__.py``: the 2-layer MEAN GraphSAGE
forward of the dense pipeline (``train.dense.dense_forward``, fanout 3) on
a 64-node power-law graph with 32 features, out_size 32, 4 classes and a
batch of 16.  The graph, the features and the batch are the JAX package's
(the port's data layer is a bit-identical copy); the weights come from a
``torch.Generator`` seeded like the JAX package's key, so they differ from
JAX's draws, and the tests carry JAX's params over with
``convert.params_from_jax``.  The sampler is a ``HopSampler`` on a
generator seeded with 1, where JAX's forward takes ``PRNGKey(1)``.

    from graphsage_torch.entry import entry
    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    embs = fn(*args)            # [16, 32]

``dryrun_multichip`` waits only for its first program, the GSPMD data- and
tensor-parallel step over ``parallel/mesh.py``'s ``model`` axis, which the
port does not have yet.  Its other three programs (the halo step, the
row-sharded cached epoch and sharded serving) are the port's
``train.distributed``, ``train.cached_dist`` and
``infer.full_graph_embeddings_sharded``, whose tests hold them against the
JAX package's and against single-process replays.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.convert import params_from_jax
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.infer import _resolve_device
from graphsage_torch.models import (GraphSageConfig, init_classifier,
                                    init_graphsage)
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train.dense import dense_forward

FANOUT = 3


def entry(device: str | torch.device | None = None):
    """Returns (fn, example_args): ``fn(params, feats, hop, batch)`` is the
    flagship forward, [16] -> [16, 32]; it runs on the card unless
    ``device="cpu"`` is given."""
    dev = _resolve_device(device)
    ds = synthetic_power_law(64, 64 * 6, num_feats=32, num_classes=4, seed=0)
    pad = ds.graph.to_padded()
    mcfg = GraphSageConfig(num_layers=2, input_size=32, out_size=32)
    gen = torch.Generator().manual_seed(0)
    params = {"sage": init_graphsage(gen, mcfg),
              "clf": init_classifier(gen, mcfg.out_size, 4)}
    batch = np.random.RandomState(0).choice(64, 16, replace=False)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def forward(params, feats, hop, batch):
        return dense_forward(params, mcfg, feats, hop, batch, fanout=FANOUT)

    hop = HopSampler(put(pad.neighbors), put(pad.degrees),
                     torch.Generator(device=dev).manual_seed(1))
    return forward, (params_from_jax(params, dev), put(ds.features), hop,
                     put(batch.astype(np.int32)))
