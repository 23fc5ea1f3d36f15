"""GraphSAGE model configuration and parameter init.

Port of the configuration half of ``graphsage_tpu/models/graphsage.py``.
``GraphSageConfig`` keeps the JAX package's fields and defaults, so a serving
``bundle.json`` means the same model to both packages.  The sampled encoder
(``Frontier``, ``graphsage_apply*``) comes with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from graphsage_torch.models.layers import init_sage_layer


@dataclasses.dataclass(frozen=True)
class GraphSageConfig:
    num_layers: int = 2          # reference src/experiments.conf:11
    input_size: int = 1433
    out_size: int = 128          # reference src/experiments.conf:12
    gcn: bool = False
    agg_func: str = "MEAN"       # MEAN | MAX | LSTM
    # The JAX package's switch between its XLA ops and its Pallas kernels.
    # Kept so that bundles read the same; the port's aggregations on the
    # card always run its CUDA kernels.
    impl: str = "xla"            # xla | pallas
    # Params stay float32; activations and the aggregated tables are kept
    # in this dtype, with float32 accumulation.
    compute_dtype: str = "float32"    # float32 | bfloat16
    # MEAN-layer restructuring (transform the table, then average H-wide
    # rows) for the sampled encoder; full-graph serving always applies it.
    mean_pretransform: str = "auto"   # auto | never | always

    def layer_input_size(self, layer: int) -> int:
        """Layer 1 consumes raw features, deeper layers consume out_size
        (reference src/models.py:237-239)."""
        return self.input_size if layer == 0 else self.out_size


def compute_dtype(cfg: GraphSageConfig) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one "
                         f"of {sorted(dtypes)}")
    return dtypes[cfg.compute_dtype]


def init_graphsage(generator: torch.Generator, cfg: GraphSageConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    """{"layers": [{"weight": [out_size, in_total]}, ...]} with xavier
    weights drawn from ``generator``."""
    if cfg.agg_func == "LSTM":
        raise NotImplementedError(
            "LSTM aggregation is not ported yet (ROADMAP, LSTM aggregator)")
    return {"layers": [
        init_sage_layer(generator, cfg.layer_input_size(i), cfg.out_size,
                        gcn=cfg.gcn, dtype=dtype)
        for i in range(cfg.num_layers)]}
