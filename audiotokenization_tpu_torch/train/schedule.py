"""The learning-rate schedules (counterpart of
``audiotokenization_tpu/train/schedule.py``): the absolute learning rate at
update ``step`` (counted from 0). ``warmup_lr_schedule``, the training
step's:

    step <  warmup:             init_lr + (max_lr - init_lr) / warmup² · step²
    warmup <= step < w + down:  linear from max_lr to min_lr
    step >= w + down:           min_lr

``cosine_decay_with_warmup_schedule``, the reference's offline harness's
(BigCodec_SSL/inference_full.py:406-418): a linear warmup, then a cosine
from max_lr down to min_lr at ``total_steps``.
"""
from __future__ import annotations

import math


def warmup_lr_schedule(*, warmup_step: int = 1000, down_step: int = 500000,
                       max_lr: float = 1e-4, min_lr: float = 1e-5, init_lr: float = 1e-5):
    alpha = (max_lr - init_lr) / max(warmup_step, 1) ** 2
    s1, s2 = warmup_step, warmup_step + down_step

    def schedule(step: int) -> float:
        if step < s1:
            return init_lr + alpha * step * step
        if step < s2:
            return (max_lr - min_lr) / (s1 - s2) * step + (min_lr * s1 - max_lr * s2) / (s1 - s2)
        return min_lr

    return schedule


def cosine_decay_with_warmup_schedule(*, total_steps: int = 1000, warmup_steps: int = 100,
                                      max_lr: float = 1e-3, min_lr: float = 1e-7):
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return max_lr * step / max(warmup_steps, 1)
        cos = 0.5 * (1.0 + math.cos(math.pi * (step - warmup_steps)
                                    / max(total_steps - warmup_steps, 1)))
        return min_lr + (max_lr - min_lr) * cos

    return schedule
