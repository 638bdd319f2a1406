"""Learning-rate schedules, including the [HZRS15a] CIFAR schedule the
paper cites — the counterparts of the JAX package's ``optim/schedule.py``.

A schedule maps a step (an int, or a 0-d integer tensor) to the learning
rate as a Python float.  Each is computed in float32 arithmetic with its
constants rounded to float32, as the reference computes it, so the two
give the same rate at every step up to float32 rounding of ``cos``.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def _step(step) -> int:
    return int(step)


def constant_schedule(lr: float):
    def fn(step):
        del step
        return float(_f32(lr))
    return fn


def resnet_paper_schedule(base_lr: float = 0.1, total_steps: int = 64000,
                          warmup_steps: int = 0, warmup_lr: float = 0.01):
    """[HZRS15a] §4.2 schedule: lr 0.1, /10 at 50% and 75% of training.

    He et al. additionally warm up ResNet-110 with lr 0.01 until the loss
    drops; a fixed warmup window serves the same purpose.
    """
    b1 = int(0.5 * total_steps)
    b2 = int(0.75 * total_steps)

    def fn(step):
        step = _step(step)
        lr = base_lr if step < b1 else (base_lr * 0.1 if step < b2
                                        else base_lr * 0.01)
        if warmup_steps and step < warmup_steps:
            lr = warmup_lr
        return float(_f32(lr))

    return fn


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = np.clip(_f32(_step(step)) / _f32(max(1, total_steps)),
                    _f32(0), _f32(1))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * t))
        return float(_f32(base_lr) * (_f32(final_frac)
                                      + _f32(1 - final_frac) * cos))
    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup_steps),
                          final_frac)

    def fn(step):
        step = _step(step)
        if step < warmup_steps:
            return float(_f32(base_lr) * _f32(step)
                         / _f32(max(1, warmup_steps)))
        return cos(step - warmup_steps)
    return fn
