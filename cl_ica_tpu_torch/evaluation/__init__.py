"""Identifiability metrics: MCC, linear R², Hungarian assignment.

The port's own copy of cl_ica_tpu/evaluation (numpy + scipy, host side).
The port imports nothing of the JAX package, so it keeps these modules
itself; tests/test_torch_evaluation.py holds them equal to the originals.
"""

from .munkres import Munkres, hungarian
from .disentanglement import (
    linear_disentanglement,
    permutation_disentanglement,
    r2_score,
)
from .mcc import compute_mcc, correlation
from .dislib_metrics import compute_mig, compute_sap

__all__ = [
    "Munkres",
    "hungarian",
    "linear_disentanglement",
    "permutation_disentanglement",
    "r2_score",
    "compute_mcc",
    "correlation",
    "compute_mig",
    "compute_sap",
]
