"""Optimizers, learning-rate schedules and gradient compression: the port
of src/repro/optim/ (no `state_axes`: that exists for NamedSharding)."""

from repro_torch.optim.compression import error_feedback_q8
from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, for_arch, sgd
from repro_torch.optim.schedules import constant, cosine_warmup, inverse_sqrt

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "for_arch",
    "constant",
    "cosine_warmup",
    "inverse_sqrt",
    "error_feedback_q8",
]
