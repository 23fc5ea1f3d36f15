from graphsage_torch.utils.obs import MetricsLogger
from graphsage_torch.utils.prefetch import Prefetcher, prefetch

__all__ = ["MetricsLogger", "Prefetcher", "prefetch"]
