"""AdamW with clip-by-global-norm, as the reference's optax chain
(counterpart of ``minddet_tpu/core/optim.py:adamw``).

``adamw(...)`` returns a recipe, as the optax transformation is one;
``recipe.init(model)`` makes the ``torch.optim.AdamW`` that holds the state
(``exp_avg``, ``exp_avg_sq``, ``step`` = optax's ``mu``, ``nu``, ``count``)
and ``recipe.update(optimizer, params)`` applies one step to the gradients in
``.grad``:

1. ``clip_by_global_norm``: when the global norm of the gradients is at
   least ``clip_global_norm``, each gradient becomes (g / norm) * max, as
   optax does (no epsilon, so not ``torch.nn.utils.clip_grad_norm_``);
2. Adam moments and bias correction;
3. decoupled weight decay on parameters with ndim > 1 only (the
   reference's ``_decay_mask``), from the same old parameter as optax's
   ``add_decayed_weights``; torch's AdamW does that in two parameter
   groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch
from torch import nn


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """In place: g <- (g / norm) * max_norm where norm >= max_norm (decided
    on the device, no host sync)."""
    over = norm >= max_norm
    divisor = torch.where(over, norm, torch.ones_like(norm))
    factor = torch.where(over, torch.full_like(norm, max_norm),
                         torch.ones_like(norm))
    torch._foreach_div_(grads, divisor)
    torch._foreach_mul_(grads, factor)


@dataclass(frozen=True)
class AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_global_norm: Optional[float] = None

    def init(self, model: nn.Module) -> torch.optim.AdamW:
        params = [p for p in model.parameters() if p.requires_grad]
        groups = [
            {"params": [p for p in params if p.ndim > 1],
             "weight_decay": self.weight_decay},
            {"params": [p for p in params if p.ndim <= 1],
             "weight_decay": 0.0},
        ]
        return torch.optim.AdamW(groups, lr=self.learning_rate,
                                 betas=(self.b1, self.b2), eps=self.eps)

    def update(self, optimizer: torch.optim.Optimizer,
               params: Iterable[torch.Tensor]) -> torch.Tensor:
        """Clip the ``.grad`` of ``params`` and step ``optimizer``. Returns
        the global norm of the gradients before the clip.

        A parameter of ``optimizer``'s groups that has no ``.grad`` (the
        loss never reached it) gets a zero gradient first, as optax gives
        it: its moments, its step count and its weight decay advance with
        the others'. ``torch.optim.AdamW`` would skip it."""
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip_global_norm:
            clip_by_global_norm_(grads, self.clip_global_norm, norm)
        optimizer.step()
        return norm


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          clip_global_norm: Optional[float] = None) -> AdamW:
    return AdamW(learning_rate, b1, b2, eps, weight_decay, clip_global_norm)
