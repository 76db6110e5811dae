from .metrics import MetricsLogger
from .trainer import Throughput, make_optimizer, make_synthetic_train_step

__all__ = [
    "MetricsLogger",
    "Throughput",
    "make_optimizer",
    "make_synthetic_train_step",
]
