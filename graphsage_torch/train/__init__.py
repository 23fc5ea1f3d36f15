from graphsage_torch.train.metrics import micro_f1

__all__ = ["micro_f1"]
