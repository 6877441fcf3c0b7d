"""Learning-rate schedules as functions of the step count (counterpart of
``minddet_tpu/core/lr_schedules.py:linear_warmup`` and ``warmup_cosine``,
built as the reference builds them from optax's ``linear_schedule``,
``cosine_decay_schedule`` and ``join_schedules``).

A schedule takes the count as a tensor (a 0-d tensor on the device in the
train step, so no step syncs the host; any integer tensor or number in a
test) and returns the learning rate as an f32 tensor on the count's
device, computed in f32 as optax computes it.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``: ``init_value`` at count 0, linear to
    ``end_value`` at ``transition_steps``, then constant."""

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(0, transition_steps).float()
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1, alpha 0):
    ``init_value`` times (1 + cos(pi c / decay_steps)) / 2, the count c held
    at ``decay_steps`` from there on."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(max=decay_steps).float()
        decay = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * decay

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax's ``join_schedules``: ``schedules[i + 1]`` from count
    ``boundaries[i]`` on, counted from that boundary."""

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, s(count - boundary))
        return out

    return schedule


def linear_warmup(learning_rate: float, warmup_steps: int, total_steps: int,
                  end_factor: float = 0.0) -> Schedule:
    """Linear warm-up from 0 to ``learning_rate`` over ``warmup_steps``,
    then linear decay to ``learning_rate * end_factor`` at
    ``total_steps`` (the reference's ``linear_warmup``, its
    ``LinearWithWarmUpLR``)."""
    warm = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))
    decay = linear_schedule(learning_rate, learning_rate * end_factor,
                            max(total_steps - warmup_steps, 1))
    return join_schedules([warm, decay], [warmup_steps])


def warmup_cosine(learning_rate: float, total_steps: int,
                  warmup_steps: int = 0) -> Schedule:
    """Linear warm-up from 0 to ``learning_rate`` over ``warmup_steps`` (at
    least 1), then cosine decay to 0 at ``total_steps`` (the reference's
    ``warmup_cosine`` at its default ``end_factor`` 0: optax's
    ``warmup_cosine_decay_schedule``)."""
    warmup_steps = max(warmup_steps, 1)
    warm = linear_schedule(0.0, learning_rate, warmup_steps)
    decay = cosine_decay_schedule(learning_rate, total_steps - warmup_steps)
    return join_schedules([warm, decay], [warmup_steps])
