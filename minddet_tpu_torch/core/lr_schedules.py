"""Learning-rate schedules as functions of the step count (counterpart of
``minddet_tpu/core/lr_schedules.py:polynomial_decay``, ``linear_warmup``,
``warmup_cosine``, ``multi_epochs_decay``, ``exponential_decay``,
``one_cycle`` and ``one_cycle_momentum``, built as the reference builds
them from optax's ``polynomial_schedule``,
``linear_schedule``, ``cosine_decay_schedule``,
``piecewise_constant_schedule``, ``join_schedules`` and
``exponential_decay``).

A schedule takes the count as a tensor (a 0-d tensor on the device in the
train step, so no step syncs the host; any integer tensor or number in a
test) and returns the learning rate as an f32 tensor on the count's
device, computed in f32 as optax computes it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
DECAY_FACTOR = 10.0  # multi_epochs_decay's divisor at each milestone
# one-cycle's shape, the reference's defaults (no config sets them)
ONE_CYCLE_DIV = 10.0  # lr_max over the starting learning rate
ONE_CYCLE_PCT_START = 0.4  # share of the steps spent warming up
ONE_CYCLE_MOMS = (0.95, 0.85)  # momentum at the start and at the peak


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``: ``init_value`` at count 0, linear to
    ``end_value`` at ``transition_steps``, then constant."""

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(0, transition_steps).float()
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    """optax's ``polynomial_schedule``: (init - end) (1 - c / T) ** power +
    end, the count c held in [0, ``transition_steps``]."""

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).clamp(0, transition_steps).float()
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac.pow(power) + end_value

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


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Dict[int, float]
                                ) -> Schedule:
    """optax's ``piecewise_constant_schedule``: ``init_value`` times every
    scale whose boundary the count has reached, applied boundary by
    boundary in their order with optax's own f32 arithmetic (v <- v ind +
    (1 - ind) scale v, ind 1 before the boundary and 0 from it on)."""
    steps = sorted(boundaries_and_scales.items())

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        v = torch.full((), init_value, dtype=torch.float32,
                       device=count.device)
        for boundary, scale in steps:
            ind = (boundary - count).sign().clamp(min=0).float()
            v = v * ind + (1 - ind) * scale * v
        return v

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


def polynomial_decay(learning_rate: float, end_learning_rate: float,
                     decay_steps: int, power: float = 1.0,
                     warmup_steps: int = 0) -> Schedule:
    """``learning_rate`` decayed to ``end_learning_rate`` as (1 - c /
    (``decay_steps`` - ``warmup_steps``)) ** ``power``, after a linear
    warm-up from 0 over ``warmup_steps`` where that is positive (the
    reference's ``polynomial_decay``, its ``CenterNetPolynomialDecayLR``;
    DeepLab's schedule)."""
    poly = polynomial_schedule(learning_rate, end_learning_rate, power,
                               max(decay_steps - warmup_steps, 1))
    if warmup_steps > 0:
        warm = linear_schedule(0.0, learning_rate, warmup_steps)
        return join_schedules([warm, poly], [warmup_steps])
    return poly


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


def multi_epochs_decay(learning_rate: float, milestones: Sequence[int],
                       steps_per_epoch: int, warmup_steps: int = 0
                       ) -> Schedule:
    """``learning_rate`` divided by ``DECAY_FACTOR`` at each milestone
    epoch (its count: milestone x ``steps_per_epoch``), after a linear
    warm-up from 0 over ``warmup_steps`` where that is positive, the
    milestones then counted from the warm-up's end (the reference's
    ``multi_epochs_decay``, its ``MultiEpochsDecayLR``)."""
    sched = piecewise_constant_schedule(
        learning_rate, {int(m) * steps_per_epoch: 1.0 / DECAY_FACTOR
                        for m in milestones})
    if warmup_steps > 0:
        warm = linear_schedule(0.0, learning_rate, warmup_steps)
        return join_schedules([warm, sched], [warmup_steps])
    return sched


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float = 0.8) -> Schedule:
    """``learning_rate * decay_rate ** floor(c / decay_steps)`` in f32, the
    value at count 0 and below ``learning_rate`` (optax's
    ``exponential_decay`` with ``staircase=True``, the reference's; both
    PointPillars configs decay by 0.8 every 27840 steps)."""

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        p = torch.floor(count.float() / decay_steps)
        lr = torch.full((), learning_rate, dtype=torch.float32,
                        device=count.device)
        decayed = learning_rate * torch.pow(
            torch.full((), decay_rate, dtype=torch.float32,
                       device=count.device), p)
        return torch.where(count <= 0, lr, decayed)

    return schedule


def one_cycle(lr_max: float, total_steps: int) -> Schedule:
    """fastai's one-cycle learning rate in f32 (the reference's
    ``one_cycle`` at its defaults, CenterPoint's nuScenes schedule): cosine
    from ``lr_max / ONE_CYCLE_DIV`` up to ``lr_max`` over the first
    ``ONE_CYCLE_PCT_START`` of ``total_steps``, then cosine down to 0, held
    at ``lr_max / ONE_CYCLE_DIV / 1e4`` at least."""
    up_steps = int(total_steps * ONE_CYCLE_PCT_START)
    down_steps = total_steps - up_steps
    low = lr_max / ONE_CYCLE_DIV

    def schedule(count) -> torch.Tensor:
        step = torch.as_tensor(count).float()
        up_frac = (step / max(up_steps, 1)).clamp(0.0, 1.0)
        lr_up = low + (lr_max - low) * 0.5 * (1 - torch.cos(math.pi
                                                            * up_frac))
        down_frac = ((step - up_steps) / max(down_steps, 1)).clamp(0.0, 1.0)
        lr_down = lr_max * 0.5 * (1 + torch.cos(math.pi * down_frac))
        lr_down = lr_down.clamp(min=lr_max / ONE_CYCLE_DIV / 1e4)
        return torch.where(step < up_steps, lr_up, lr_down)

    return schedule


def one_cycle_momentum(total_steps: int) -> Schedule:
    """The momentum leg of one-cycle in f32, the mirror of the learning
    rate: cosine from ``ONE_CYCLE_MOMS[0]`` down to ``ONE_CYCLE_MOMS[1]``
    over the first ``ONE_CYCLE_PCT_START`` of ``total_steps``, then back up
    (the reference's ``one_cycle_momentum`` at its defaults)."""
    up_steps = int(total_steps * ONE_CYCLE_PCT_START)
    down_steps = total_steps - up_steps
    hi, lo = ONE_CYCLE_MOMS

    def schedule(count) -> torch.Tensor:
        step = torch.as_tensor(count).float()
        up_frac = (step / max(up_steps, 1)).clamp(0.0, 1.0)
        m_up = hi + (lo - hi) * 0.5 * (1 - torch.cos(math.pi * up_frac))
        down_frac = ((step - up_steps) / max(down_steps, 1)).clamp(0.0, 1.0)
        m_down = lo + (hi - lo) * 0.5 * (1 - torch.cos(math.pi * down_frac))
        return torch.where(step < up_steps, m_up, m_down)

    return schedule
