from . import checkpoint
from .checkpoint import load_resume_state, save_resume_state
from .capture import CapturedStep
from .metrics import MetricsLogger
from .trainer import CosineLR, Throughput, make_optimizer, make_synthetic_train_step

__all__ = [
    "CapturedStep",
    "CosineLR",
    "MetricsLogger",
    "Throughput",
    "checkpoint",
    "load_resume_state",
    "make_optimizer",
    "make_synthetic_train_step",
    "save_resume_state",
]
