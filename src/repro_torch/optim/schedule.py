"""Learning-rate schedules: plain functions of an int step -> float.

Copies ``repro.optim.schedule``.  The reference evaluates them in f32;
so does the port (numpy float32), so both hand the optimizer the same
learning rate.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant_schedule(lr: float):
    return lambda step: float(_f32(lr))


def linear_schedule(lr: float, total_steps: int, warmup: int = 0):
    def f(step: int) -> float:
        # the reference forms warm and decay from a Python step (f64),
        # then multiplies in f32
        warm = _f32(min(step / max(warmup, 1), 1.0)) if warmup else _f32(1)
        decay = _f32(max(1.0 - step / max(total_steps, 1), 0.0))
        return float(_f32(lr) * warm * decay)
    return f


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    min_ratio: float = 0.1):
    def f(step: int) -> float:
        s = _f32(step)
        warm = s / _f32(max(warmup, 1)) if s < warmup else _f32(1.0)
        prog = np.clip((s - _f32(warmup)) / _f32(max(total_steps - warmup, 1)),
                       _f32(0.0), _f32(1.0))
        # cos in f64, rounded once: as close to XLA's f32 cos as numpy gets
        c = _f32(np.cos(np.float64(_f32(np.pi) * prog)))
        cos = _f32(min_ratio) + _f32((1 - min_ratio) * 0.5) * (_f32(1) + c)
        return float(_f32(lr) * warm * cos)
    return f
