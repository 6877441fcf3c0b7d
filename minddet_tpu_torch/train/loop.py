"""The training step and loop (counterpart of ``minddet_tpu/train/loop.py``:
``TrainState``, ``create_train_state``, ``make_train_step`` and
``Trainer``).

The reference's step is a pure jitted function from one state to the next.
Here the step updates the state in place: the model's parameters and BN
running statistics, the optimizer's state and the step count. One step
runs the loss, the backward, the clip and the optimizer (``core/optim.py``:
AdamW or SGD); BN statistics are updated by the train-mode forward
itself. ``Trainer`` drives the step over an iterator of batches with
metrics and checkpoints on one device (the reference's mesh waits for the
DDP / FSDP port).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from minddet_tpu_torch.core.metrics import MetricWriter, StepTimer
from minddet_tpu_torch.core.optim import Recipe, load_optimizer_state

Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[nn.Module, Dict], Tuple[torch.Tensor, Metrics]]


@dataclass
class TrainState:
    """The model (params + BN statistics), its optimizer and the step
    count; mutated in place by the train step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Recipe
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Recipe) -> "TrainState":
        return cls(model=model, optimizer=tx.init(model), tx=tx)

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the model's parameters and BN buffers,
        the optimizer's state (the schedule's count among its groups'
        entries) and the step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s output in place
        (``load_optimizer_state``: the groups' shared tensors tied again)."""
        self.model.load_state_dict(state["model"])
        load_optimizer_state(self.optimizer, state["optimizer"])
        self.step = int(state["step"])


def to_device(batch: Dict, device) -> Dict:
    """``batch`` with numpy arrays and tensors on ``device``; ``step``
    (the batch's draw index) stays as it is."""
    return {k: v if k == "step" else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def create_train_state(model: nn.Module, generator: torch.Generator,
                       sample_batch: Optional[Dict], tx: Recipe,
                       device=None) -> TrainState:
    """The reference's ``create_train_state``: ``model``'s weights drawn
    from ``generator`` (its ``init_weights``, flax's initialisers), the
    model on ``device`` (where None, the device of ``sample_batch``'s first
    tensor, else the CPU) in ``channels_last`` memory and train mode, and
    ``tx``'s optimizer over it. The port's modules are built eagerly, so
    ``sample_batch`` is read for its device only."""
    if device is None:
        device = next((v.device for v in (sample_batch or {}).values()
                       if torch.is_tensor(v)), torch.device("cpu"))
    model.init_weights(generator)
    model = model.to(device=device, memory_format=torch.channels_last)
    return TrainState.create(model.train(), tx)


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


class Trainer:
    """Drives ``train_step`` over an iterator of batches with metrics and
    checkpoints (the reference's ``Trainer``, on one device)."""

    def __init__(self, state: TrainState, train_step: Callable,
                 metric_writer: Optional[MetricWriter] = None,
                 checkpoint_manager=None, log_every: int = 50,
                 save_every: int = 1000,
                 eval_fn: Optional[Callable[[TrainState],
                                            Dict[str, float]]] = None,
                 eval_every: int = 0):
        self.state = state
        self.train_step = train_step
        self.writer = metric_writer or MetricWriter()
        self.ckpt = checkpoint_manager
        self.log_every = log_every
        self.save_every = max(1, save_every)
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.timer = StepTimer()
        self.device = next(state.model.parameters()).device

    def fit(self, batches: Iterable[Dict], num_steps: Optional[int] = None,
            batch_size: Optional[int] = None, start_step: int = 0
            ) -> TrainState:
        """Run ``num_steps`` steps (all the batches where None), counting
        from ``start_step`` on the host: the metrics are read (a host sync)
        only at a log step (every ``log_every`` and the last, with
        ``img_per_sec`` where ``batch_size`` is given), an eval step and a
        save step (every ``save_every``, forced at the last); the writer
        thread is joined at the end."""
        step = start_step
        for i, batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            batch = to_device(batch, self.device)
            self.state, metrics = self.train_step(self.state, batch)
            self.timer.tick()
            step += 1
            last = num_steps is not None and i == num_steps - 1
            if step % self.log_every == 0 or last:
                metrics = {k: float(v) for k, v in metrics.items()}
                if batch_size:
                    metrics["img_per_sec"] = self.timer.throughput(batch_size)
                self.writer.write(step, metrics)
            if self.eval_fn is not None and self.eval_every and (
                    step % self.eval_every == 0 or last):
                self.writer.write(step, {f"eval/{k}": float(v) for k, v in
                                         self.eval_fn(self.state).items()})
            if self.ckpt is not None and (step % self.save_every == 0
                                          or last):
                self.ckpt.save(step, self.state.state_dict(), force=last)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.state
