from graphsage_torch.train.cached_dist_trainer import CachedDistTrainer
from graphsage_torch.train.cached_trainer import CachedTrainer
from graphsage_torch.train.dist_trainer import DistTrainConfig, DistTrainer
from graphsage_torch.train.metrics import micro_f1
from graphsage_torch.train.optim import clip_by_global_norm, sgd_update
from graphsage_torch.train.trainer import Trainer, TrainConfig

__all__ = [
    "CachedDistTrainer",
    "CachedTrainer",
    "DistTrainConfig",
    "DistTrainer",
    "clip_by_global_norm",
    "micro_f1",
    "sgd_update",
    "Trainer",
    "TrainConfig",
]
