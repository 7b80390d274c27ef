"""Learning-rate schedules: step (int) -> lr (float).

Port of src/repro/optim/schedules.py; the JAX functions take and return
traced scalars (int32 step, fp32 lr), these a Python int and float.
"""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def cosine_warmup(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to peak, cosine decay to floor*peak."""

    def f(step):
        step = float(step)
        if step < warmup:
            return peak_lr * min(step / max(warmup, 1), 1.0)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))

    return f


def inverse_sqrt(peak_lr: float, warmup: int):
    def f(step):
        step = max(float(step), 1.0)
        return peak_lr * min(step / max(warmup, 1), math.sqrt(warmup / step))

    return f
