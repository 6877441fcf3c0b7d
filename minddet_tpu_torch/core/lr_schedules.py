"""Learning-rate schedules as functions of the step count (counterpart of
``minddet_tpu/core/lr_schedules.py:linear_warmup``, built as the reference
builds it from optax's ``linear_schedule`` and ``join_schedules``).

A schedule takes the count as a tensor (a 0-d tensor on the device in the
train step, so no step syncs the host; any integer tensor or number in a
test) and returns the learning rate as an f32 tensor on the count's
device, computed in f32 as optax computes it.
"""

from __future__ import annotations

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
