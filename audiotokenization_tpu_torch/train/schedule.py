"""The learning-rate schedule (counterpart of
``audiotokenization_tpu/train/schedule.py::warmup_lr_schedule``): the
absolute learning rate at update ``step`` (counted from 0),

    step <  warmup:             init_lr + (max_lr - init_lr) / warmup² · step²
    warmup <= step < w + down:  linear from max_lr to min_lr
    step >= w + down:           min_lr
"""
from __future__ import annotations


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
