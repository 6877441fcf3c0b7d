"""Weights from the JAX package's flax variables into the port's modules.

``centernet_from_flax(model, variables)`` takes the ``{"params",
"batch_stats"}`` tree of the JAX ``CenterNet`` as nested dicts of numpy
arrays and loads every parameter and running statistic of the port's
``CenterNet``. The mapping is a bijection: each flax leaf is used once, each
port parameter and buffer is set (``num_batches_tracked``, which eval never
reads, is left alone), and anything missing, left over or of the wrong shape
raises.

Layouts:

- ``nn.Conv2d`` weight (O, I, kh, kw) <- flax ``kernel`` (kh, kw, I, O);
- ``nn.Linear`` weight (O, I) <- the flax ``Dense`` kernel (I, O);
- ``nn.ConvTranspose2d`` weight (I, O, kh, kw) <- the flax ``ConvTranspose``
  kernel (kh, kw, I, O) flipped in space: flax does not flip the kernel and
  pads SAME k4/s2 by (2, 2), which is torch's ``padding=1`` with the flip
  (the inverse of ``minddet_tpu/utils/convert.py``'s torch->flax rule);
  at kernel = stride (the SECOND RPN's ups) SAME pads by (s-1, s-1), which
  is torch's ``padding=0`` with the same flip;
- ``ModulatedDeformConv.kernel`` keeps the flax (kh, kw, Cin, Cout) layout;
- BN (and the PFN's ``MaskedBatchNorm``) ``scale``/``bias``/``mean``/
  ``var`` -> ``weight``/``bias``/``running_mean``/``running_var``.

``pointpillars_from_flax`` does the same for the JAX ``PointPillars``
(``reader/pfn0/{linear,norm}``, ``rpn/block{i}_*``, ``rpn/up{i}_*``,
``conv_{cls,box,dir}``). Its tree has one layout whether the reference ran
with ``rpn_space_to_depth`` or ``rpn_scan_inner`` or not; the pre-stacked
``rpn_stacked_params`` layout is not taken. Buffers that are not part of the
state dict (the anchors) are no weights and are left alone.

``adamw_state_from_optax(model, optimizer, opt_state)`` carries the optax
AdamW state of a JAX train state over as well (``mu``, ``nu``, ``count`` ->
``exp_avg``, ``exp_avg_sq``, ``step``), through the same leaf mapping and
the same bijection checks, so a JAX training run resumes in the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from minddet_tpu_torch.models.layers import DeconvBlock, ModulatedDeformConv
from minddet_tpu_torch.models.readers.pillar_encoder import MaskedBatchNorm

# children whose flax scope has flax's automatic name
_RENAMES = {DeconvBlock: {"bn1": "BatchNorm_0", "bn2": "BatchNorm_1"}}

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _flax_leaves(tree: Dict, prefix: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _flax_scope(model: nn.Module, module_path: str) -> Tuple[str, ...]:
    scope = []
    parent = model
    for name in module_path.split(".") if module_path else ():
        scope.append(_RENAMES.get(type(parent), {}).get(name, name))
        parent = getattr(parent, name)
    return tuple(scope)


def _source(module: nn.Module, leaf: str):
    """(collection, flax leaf, transform) for one port tensor."""
    if isinstance(module, (nn.BatchNorm2d, MaskedBatchNorm)):
        col, name = _BN_LEAVES[leaf]
        return col, name, lambda a: a
    if isinstance(module, ModulatedDeformConv):
        return "params", leaf, lambda a: a  # the kernel as it is
    if isinstance(module, nn.ConvTranspose2d) and leaf == "weight":
        return "params", "kernel", \
            lambda a: a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if isinstance(module, nn.Linear) and leaf == "weight":
        return "params", "kernel", lambda a: a.T
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return "params", "kernel", lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)) and leaf == "bias":
        return "params", "bias", lambda a: a
    raise KeyError(f"no flax counterpart for {type(module).__name__}.{leaf}")


def _matched(model: nn.Module, tensors, leaves: Dict
             ) -> List[Tuple[str, torch.Tensor, np.ndarray]]:
    """Pair every (name, port tensor) with its flax leaf in ``leaves``
    (keyed by (collection,) + flax path), laid out as the port's: each leaf
    used once, none left over, shapes equal; raises otherwise."""
    used = set()
    pairs = []
    for name, tensor in tensors:
        module_path, _, leaf = name.rpartition(".")
        col, flax_leaf, fn = _source(model.get_submodule(module_path), leaf)
        key = (col,) + _flax_scope(model, module_path) + (flax_leaf,)
        if key not in leaves:
            raise KeyError(f"{name}: flax leaf {'/'.join(key)} missing")
        if key in used:
            raise ValueError(f"flax leaf {'/'.join(key)} used twice")
        used.add(key)
        value = np.array(fn(leaves[key]), order="C")  # a writable copy
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: shape {tuple(tensor.shape)} != flax "
                             f"{'/'.join(key)} {value.shape} after layout")
        pairs.append((name, tensor, value))
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise ValueError(f"flax leaves with no port tensor: {unused}")
    return pairs


@torch.no_grad()
def load_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load a flax ``{"params", "batch_stats"}`` tree into ``model`` (whose
    module paths mirror the flax scopes) as a bijection; returns ``model``."""
    leaves = {(col,) + path: arr
              for col in ("params", "batch_stats")
              for path, arr in _flax_leaves(variables.get(col, {}))}
    extra_cols = set(variables) - {"params", "batch_stats"}
    if extra_cols:
        raise ValueError(f"unexpected flax collections {sorted(extra_cols)}")
    state = model.state_dict()
    tensors = list(model.named_parameters()) + [
        (n, b) for n, b in model.named_buffers()
        if n in state and not n.endswith("num_batches_tracked")]
    for _, tensor, value in _matched(model, tensors, leaves):
        tensor.copy_(torch.from_numpy(value).to(tensor.dtype))
    return model


def centernet_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``CenterNet`` variables into the port's ``CenterNet``."""
    return load_from_flax(model, variables)


def pointpillars_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``PointPillars`` variables (per-layer RPN layout) into
    the port's ``PointPillars``."""
    return load_from_flax(model, variables)


def _adam_states(state) -> List:
    """Every node of an optax state tree with ``mu``, ``nu`` and ``count``
    (``ScaleByAdamState``), found by its fields: the port imports no optax."""
    if all(hasattr(state, f) for f in ("mu", "nu", "count")):
        return [state]
    if isinstance(state, (tuple, list)):
        return [s for sub in state for s in _adam_states(sub)]
    inner = getattr(state, "inner_state", None)
    return [] if inner is None else _adam_states(inner)


@torch.no_grad()
def adamw_state_from_optax(model: nn.Module,
                           optimizer: torch.optim.Optimizer,
                           opt_state) -> torch.optim.Optimizer:
    """Load optax's Adam state (``mu``, ``nu``: param-shaped trees of
    arrays; ``count``) into ``optimizer``'s ``exp_avg``, ``exp_avg_sq`` and
    ``step`` for every parameter of ``model``. ``opt_state`` is the state of
    the reference's ``adamw`` chain (clip, then masked AdamW), leaves as
    numpy or JAX arrays; it must hold exactly one Adam state. Returns
    ``optimizer``."""
    found = _adam_states(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (mu, nu, count) in "
                         f"opt_state, found {len(found)}")
    adam = found[0]
    count = float(np.asarray(adam.count))
    params = list(model.named_parameters())
    moments = {}
    for field, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        leaves = {("params",) + path: arr
                  for path, arr in _flax_leaves(tree)}
        for name, _, value in _matched(model, params, leaves):
            moments.setdefault(name, {})[field] = value
    names = {id(p): n for n, p in params}
    if {id(p) for g in optimizer.param_groups for p in g["params"]} != set(
            names):
        raise ValueError("the optimizer's parameters are not the model's")
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            state = optimizer.state[p]
            for field, value in moments[names[id(p)]].items():
                state[field] = torch.from_numpy(value).to(p.device, p.dtype)
            state["step"] = torch.tensor(
                count, dtype=torch.float32,
                device=p.device if on_device else "cpu")
    return optimizer
