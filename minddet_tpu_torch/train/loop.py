"""The training step (counterpart of ``minddet_tpu/train/loop.py``:
``TrainState`` and ``make_train_step``).

The reference's step is a pure jitted function from one state to the next.
Here the step updates the state in place: the model's parameters and BN
running statistics, the optimizer's moments and the step count. One step
runs the loss, the backward, the clip and AdamW (``core/optim.py``); BN
statistics are updated by the train-mode forward itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from minddet_tpu_torch.core.optim import AdamW

Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[nn.Module, Dict], Tuple[torch.Tensor, Metrics]]


@dataclass
class TrainState:
    """The model (params + BN statistics), its optimizer and the step
    count; mutated in place by the train step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: AdamW
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW) -> "TrainState":
        return cls(model=model, optimizer=tx.init(model), tx=tx)


def make_train_step(loss_fn: LossFn
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                           Metrics]]:
    """Build the train step. ``loss_fn(model, batch)`` returns ``(total,
    parts)``. ``step(state, batch)`` puts the model in train mode, updates
    ``state`` in place and returns ``(state, metrics)`` with the loss, its
    parts and ``grad_norm``, the global norm of the gradients before the
    clip; metrics stay on the device (no host sync)."""

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Metrics]:
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total, parts = loss_fn(model, batch)
        total.backward()
        grad_norm = state.tx.update(state.optimizer, model.parameters())
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step
