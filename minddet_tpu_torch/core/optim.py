"""Adam, AdamW and SGD with clip-by-global-norm, as the reference's optax
chains (counterpart of ``minddet_tpu/core/optim.py``: ``adam``, ``adamw``,
``sgd`` and ``skip_nonfinite_updates``).

``adam(...)``, ``adamw(...)`` and ``sgd(...)`` return a recipe, as the
optax transformation is one; ``recipe.init(model)`` makes the torch
optimizer that holds the state and ``recipe.update(optimizer, params)``
applies one step to the gradients in ``.grad``. AdamW
(``torch.optim.AdamW``; ``exp_avg``, ``exp_avg_sq``, ``step`` = optax's
``mu``, ``nu``, ``count``):

1. ``clip_by_global_norm``: when the global norm of the gradients is at
   least ``clip_global_norm``, each gradient becomes (g / norm) * max, as
   optax does (no epsilon, so not ``torch.nn.utils.clip_grad_norm_``);
2. Adam moments and bias correction;
3. decoupled weight decay on parameters with ndim > 1 only (the
   reference's ``_decay_mask``), from the same old parameter as optax's
   ``add_decayed_weights``; torch's AdamW does that in two parameter
   groups.

``adam(...)`` is the reference's ``adam`` without decay, optax's ``adam``:
the same AdamW at weight decay 0 (no config decays an ``adam``; a
``weight_decay`` key raises).

SGD (``torch.optim.SGD``, fused; ``momentum_buffer`` = optax's ``trace``,
zero at first as optax's is): the same clip, then ``add_decayed_weights`` on
parameters with ndim > 1 (g + wd * p, again two groups), then optax's
momentum trace (t = g + momentum * t) and -lr * t, or with ``nesterov``
-lr * (g + momentum * t).

A learning rate is a number or a schedule of the step count
(``core/lr_schedules.py``), evaluated on the device: the groups share one
lr tensor and one count (``count`` in each group), and the optimizer is
torch's fused one, which reads the lr tensor on the device.

``skip_nonfinite_updates(tx)`` is optax's ``apply_if_finite`` (the
reference's NaN guard, on by default in ``build_optimizer``): where any
gradient is not finite the step leaves the parameters, the momentum trace
or both Adam moments and Adam's count, and the schedule's count as they
were. The test stays on the device: the fused step reads it as
``found_inf`` (and takes back its count's increment), so no step syncs the
host. An AdamW with a constant lr and no guard (the CenterNet, CenterPoint
and PointPillars train entries) stays torch's default implementation.

``adam``, ``adamw`` and ``sgd`` are registered in ``OPTIMIZERS``;
``build_optimizer(cfg, lr)`` builds a config's ``optimizer`` section with
the NaN guard unless it sets ``nan_guard: false``. ``with_ema(tx, decay)``
is the reference's ``optax.chain(tx, optax.ema(decay, debias=True))``: the
update that ``tx`` makes is replaced by the bias-corrected moving average
of ``tx``'s updates, with its own count; ``get_ema_params`` reads that
average, as the reference's reads ``EmaState.ema``. ``load_optimizer_state``
restores a saved state and ties the groups' shared tensors together again.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Union

import torch
from torch import nn

from minddet_tpu_torch.core.lr_schedules import Schedule
from minddet_tpu_torch.core.registry import OPTIMIZERS


def _global_norm64(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``), summed in f64 and returned in f32: torch's f32 norm
    on the CPU sums a tensor of 12.8M values (the R-CNN box head's ``fc1``)
    5e-4 away from the exact value."""
    return _global_norm64(tensors).float()


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


def _decay_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """Two parameter groups: ndim > 1 decayed, the rest not (the
    reference's ``_decay_mask``); frozen parameters in neither."""
    params = [p for p in model.parameters() if p.requires_grad]
    return [{"params": [p for p in params if p.ndim > 1],
             "weight_decay": weight_decay},
            {"params": [p for p in params if p.ndim <= 1],
             "weight_decay": 0.0}]


def _schedule_groups(groups: List[dict], lr, dev) -> Union[float,
                                                            torch.Tensor]:
    """With a schedule ``lr``, give every group one shared 0-d lr tensor
    and count on ``dev`` and return the lr tensor; else return ``lr``."""
    if not callable(lr):
        return lr
    lr = torch.zeros((), device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for group in groups:
        group.update(lr=lr, count=count)
    return lr


def _clip_and_step(optimizer: torch.optim.Optimizer,
                   params: Iterable[torch.Tensor],
                   clip_global_norm: Optional[float],
                   schedule: Optional[Schedule] = None,
                   nan_guard: bool = False) -> torch.Tensor:
    """Clip the ``.grad`` of ``params`` and step ``optimizer``. Returns the
    global norm of the gradients before the clip.

    A parameter of ``optimizer``'s groups that has no ``.grad`` (the loss
    never reached it) gets a zero gradient first, as optax gives it: its
    moments or trace, its step count and its weight decay advance with the
    others'. A torch optimizer would skip it. With a ``schedule`` the
    groups' lr tensor takes its value at the groups' count first, and the
    count advances after the step. With ``nan_guard`` (a fused optimizer)
    a step whose gradients are not all finite changes nothing; the test is
    that their f64 norm is finite (f32 and bf16 values cannot overflow
    it)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params if p.grad is not None]
    norm64 = _global_norm64(grads)
    norm = norm64.float()
    if clip_global_norm:
        clip_by_global_norm_(grads, clip_global_norm, norm)
    if nan_guard:
        finite = torch.isfinite(norm64)
        optimizer.found_inf = (~finite).float()  # read by the fused step
    if schedule is not None:
        group = optimizer.param_groups[0]
        group["lr"].copy_(schedule(group["count"]))
    optimizer.step()
    if schedule is not None:
        group["count"].add_(finite if nan_guard else 1)
    return norm


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_global_norm: Optional[float] = None
    nan_guard: bool = False  # set by skip_nonfinite_updates

    def init(self, model: nn.Module) -> torch.optim.AdamW:
        groups = _decay_groups(model, self.weight_decay)
        fused = callable(self.learning_rate) or self.nan_guard
        lr = _schedule_groups(groups, self.learning_rate,
                              next(model.parameters()).device)
        return torch.optim.AdamW(groups, lr=lr, betas=(self.b1, self.b2),
                                 eps=self.eps, fused=fused or None)

    def update(self, optimizer: torch.optim.Optimizer,
               params: Iterable[torch.Tensor]) -> torch.Tensor:
        """Clip the ``.grad`` of ``params`` and step ``optimizer``; returns
        the global norm before the clip (``_clip_and_step``)."""
        schedule = self.learning_rate if callable(self.learning_rate) \
            else None
        return _clip_and_step(optimizer, params, self.clip_global_norm,
                              schedule, self.nan_guard)


@dataclass(frozen=True)
class SGD:
    learning_rate: Union[float, Schedule]
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    clip_global_norm: Optional[float] = None
    nan_guard: bool = False  # set by skip_nonfinite_updates

    def init(self, model: nn.Module) -> torch.optim.SGD:
        groups = _decay_groups(model, self.weight_decay)
        lr = _schedule_groups(groups, self.learning_rate,
                              next(model.parameters()).device)
        opt = torch.optim.SGD(groups, lr=lr, momentum=self.momentum,
                              nesterov=self.nesterov, fused=True)
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt

    def update(self, optimizer: torch.optim.Optimizer,
               params: Iterable[torch.Tensor]) -> torch.Tensor:
        """Clip the ``.grad`` of ``params`` and step ``optimizer``; returns
        the global norm before the clip (``_clip_and_step``)."""
        schedule = self.learning_rate if callable(self.learning_rate) \
            else None
        return _clip_and_step(optimizer, params, self.clip_global_norm,
                              schedule, self.nan_guard)


Recipe = Union[AdamW, SGD]


@dataclass(frozen=True)
class WithEMA:
    """``tx`` followed by optax's ``ema(decay, debias=True)``
    (``with_ema``). Each parameter's ``"ema"`` state (made at the first
    step, after ``tx``'s own state: torch's Adam makes its moments only in
    an empty state) and the groups' shared ``"ema_count"`` hold the average
    and its count."""

    tx: Recipe
    decay: float = 0.9998

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        optimizer = self.tx.init(model)
        count = torch.zeros((), dtype=torch.int64,
                            device=next(model.parameters()).device)
        for group in optimizer.param_groups:
            group["ema_count"] = count
        return optimizer

    def update(self, optimizer: torch.optim.Optimizer,
               params: Iterable[torch.Tensor]) -> torch.Tensor:
        """``tx``'s step, whose update u is then replaced: ema <- (1 -
        decay) u + decay ema, count + 1, and the parameter moves by ema /
        (1 - decay ** count) from where it was. Returns ``tx``'s global
        norm."""
        ps = [p for group in optimizer.param_groups for p in group["params"]]
        before = [p.detach().clone() for p in ps]
        norm = self.tx.update(optimizer, params)
        with torch.no_grad():
            emas = [optimizer.state[p].setdefault("ema", torch.zeros_like(p))
                    for p in ps]
            updates = torch._foreach_sub([p.detach() for p in ps], before)
            torch._foreach_mul_(emas, self.decay)
            torch._foreach_add_(emas, updates, alpha=1 - self.decay)
            count = optimizer.param_groups[0]["ema_count"]
            count.add_(1)
            correction = 1 - torch.pow(
                torch.full((), self.decay, device=count.device), count)
            torch._foreach_add_(before, torch._foreach_div(emas, correction))
            torch._foreach_copy_([p.detach() for p in ps], before)
        return norm


def with_ema(tx: Recipe, decay: float = 0.9998) -> WithEMA:
    """The reference's ``with_ema``: ``tx`` chained with optax's
    ``ema(decay, debias=True)`` (``WithEMA``)."""
    return WithEMA(tx, decay)


def get_ema_params(model: nn.Module, optimizer: torch.optim.Optimizer
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The moving average of a ``with_ema`` optimizer by parameter name of
    ``model`` (the reference's ``EmaState.ema``), or None without one."""
    if "ema_count" not in optimizer.param_groups[0]:
        return None
    return {name: optimizer.state[p].get("ema", torch.zeros_like(p))
            for name, p in model.named_parameters()}


SHARED_GROUP_KEYS = ("lr", "count", "ema_count")


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: Dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, then every group's
    schedule lr, count and EMA count tensors made group 0's again: the
    groups share them (``_schedule_groups``, ``WithEMA``) and a step
    advances group 0's only, but the load gives each group its own copy."""
    optimizer.load_state_dict(state_dict)
    first = optimizer.param_groups[0]
    for group in optimizer.param_groups[1:]:
        for key in SHARED_GROUP_KEYS:
            if torch.is_tensor(first.get(key)):
                group[key] = first[key]


def skip_nonfinite_updates(tx: Recipe) -> Recipe:
    """``tx`` with optax's ``apply_if_finite`` around it (the reference's
    ``skip_nonfinite_updates``): a step whose gradients are not all finite
    leaves the parameters, the optimizer's state (SGD's momentum trace,
    Adam's moments and count) and the schedule's count unchanged, decided
    on the device."""
    return replace(tx, nan_guard=True)


@OPTIMIZERS.register_module()
def adam(learning_rate: Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         clip_global_norm: Optional[float] = None) -> AdamW:
    """The reference's ``adam`` without weight decay (optax's ``adam``;
    UNet's and CenterNet's optimizer)."""
    return AdamW(learning_rate, b1, b2, eps, 0.0, clip_global_norm)


@OPTIMIZERS.register_module()
def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
          clip_global_norm: Optional[float] = None) -> AdamW:
    return AdamW(learning_rate, b1, b2, eps, weight_decay, clip_global_norm)


@OPTIMIZERS.register_module()
def sgd(learning_rate: Union[float, Schedule], momentum: float = 0.9,
        nesterov: bool = False, weight_decay: float = 0.0,
        clip_global_norm: Optional[float] = None) -> SGD:
    return SGD(learning_rate, momentum, nesterov, weight_decay,
               clip_global_norm)


def build_optimizer(cfg, learning_rate: Union[float, Schedule]) -> Recipe:
    """A config's ``optimizer`` section -> its recipe through
    ``OPTIMIZERS`` at ``learning_rate``, inside ``skip_nonfinite_updates``
    unless the section sets ``nan_guard: false`` (the reference's
    ``build_optimizer``)."""
    cfg = dict(cfg)
    cfg["learning_rate"] = learning_rate
    nan_guard = cfg.pop("nan_guard", True)
    tx = OPTIMIZERS.build(cfg)
    return skip_nonfinite_updates(tx) if nan_guard else tx
