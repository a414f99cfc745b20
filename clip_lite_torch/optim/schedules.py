"""Warmup + decay LR multiplier schedules, the JAX package's
``optim/schedules.py`` as plain Python functions of the step.

torch's LambdaLR convention: the i-th optimizer step (1-indexed) runs at
multiplier f(i - 1), so the very first step runs at LR 0 during warmup.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def linear_warmup_no_decay(total_steps: int, warmup_steps: int) -> Schedule:
    """Linear warmup, then constant."""
    assert warmup_steps < total_steps, "Warmup steps must be < total steps."

    def fn(step: int) -> float:
        mult = step / max(1, warmup_steps) if step < warmup_steps else 1.0
        return max(0.0, mult)

    return fn


def linear_warmup_multistep(total_steps: int, warmup_steps: int,
                            milestones: Sequence[int],
                            gamma: float = 0.1) -> Schedule:
    """Linear warmup, then step decay by ``gamma`` at each milestone."""
    milestones = list(milestones)
    assert milestones == sorted(milestones), "milestones must be increasing"
    assert milestones[0] > warmup_steps, "first milestone must be after warmup"
    assert milestones[-1] < total_steps, "last milestone must be < total steps"

    def fn(step: int) -> float:
        if step < warmup_steps:
            return max(0.0, step / max(1, warmup_steps))
        return max(0.0, gamma ** sum(step >= m for m in milestones))

    return fn


def linear_warmup_linear_decay(total_steps: int, warmup_steps: int) -> Schedule:
    """Linear warmup, then linear decay to zero."""
    assert warmup_steps < total_steps, "Warmup steps must be < total steps."

    def fn(step: int) -> float:
        if step < warmup_steps:
            return max(0.0, step / max(1, warmup_steps))
        return max(0.0, (total_steps - step) / (total_steps - warmup_steps))

    return fn


def linear_warmup_cosine(total_steps: int, warmup_steps: int,
                         min_mult: float = 0.0) -> Schedule:
    """Linear warmup, then cos^2 decay with a floor:
    mult = min_mult + cos^2((step - w) / (T - w) * pi/2)."""
    assert warmup_steps < total_steps, "Warmup steps must be < total steps."

    def fn(step: int) -> float:
        if step < warmup_steps:
            return max(0.0, step / max(1, warmup_steps))
        factor = (step - warmup_steps) / (total_steps - warmup_steps)
        return max(0.0, min_mult + math.cos(factor * (math.pi / 2)) ** 2)

    return fn


SCHEDULES = {
    "none": linear_warmup_no_decay,
    "multistep": linear_warmup_multistep,
    "linear": linear_warmup_linear_decay,
    "cosine": linear_warmup_cosine,
}
