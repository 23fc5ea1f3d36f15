from graphsage_torch.sampler.compact import CompactBatch, build_compact_batch
from graphsage_torch.sampler.pairs import PairBatch, PairSampler

__all__ = [
    "CompactBatch",
    "build_compact_batch",
    "PairBatch",
    "PairSampler",
]
