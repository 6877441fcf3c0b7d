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

``centerpoint_from_flax`` does it for the JAX ``CenterPoint`` and
``CenterPointTwoStage`` (``reader/pfn{i}``, ``rpn/...`` with the strided
``up0_downconv``, ``head/shared_conv``, ``head/shared_bn``,
``head/task{t}/{name}_conv0|_bn0|_out``, and for the two-stage model
``refine/fc{i}|bn{i}|score|box``; ``extractor`` has no parameters), again
from the per-layer RPN tree only.

``faster_rcnn_from_flax`` and ``mask_rcnn_from_flax`` do it for the JAX
``FasterRCNN`` and ``MaskRCNN`` (``backbone/conv1``, ``backbone/bn1``,
``backbone/layer{s}_{i}/...`` with the Bottleneck's ``conv3``/``bn3``,
``fpn/lateral{i}|smooth{i}``, ``rpn/conv|cls|reg``, ``box_head/fc1|fc2|cls|
reg``, ``mask_head/conv{i}|up|out``; the mask head's 2x2 stride-2
``ConvTranspose`` is flipped like every other). The anchors are no weights.

``yolov8_from_flax`` does it for the JAX ``YOLOv8`` (``backbone/stem``,
``backbone/stage{i}/in|b{j}/c1|c2|out``, ``backbone/sppf/in|out``,
``neck/td4|td3|down3|bu4|down4|bu5``, ``head/reg{i}_0|reg{i}_1|reg_out{i}|
cls{i}_0|cls{i}_1|cls_out{i}``, each ConvBlock's ``conv`` and ``bn``).

``yolox_from_flax`` does it for the JAX ``YOLOX`` (the same ``backbone``,
``neck/reduce5|td4|reduce4|td3|down3|bu4|down4|bu5``, ``head/stem{i}|
cls{i}_{j}|reg{i}_{j}|cls_out{i}|reg_out{i}|obj_out{i}``) and
``yolov5_from_flax`` for the JAX ``YOLOv5`` (``backbone``, the same
``neck``, the 1x1 ``head{i}`` convs).

``yolov4_from_flax`` and ``yolov7_from_flax`` do it for the JAX ``YOLOv4``
(``backbone/stem|down{s}|stage{s}/main|skip|b{i}_c1|b{i}_c2|post|out``, each
``MishConv``'s ``conv`` and ``bn``) and ``YOLOv7`` (``backbone/stem{i}|
down1|stage{s}/in_a|in_b|t{t}_{j}|out|mp{s}/pool_proj|pre|down``), the same
``neck`` and ``head{i}`` as YOLOv5's; ``yolov3_from_flax`` for the JAX
``YOLOv3`` (``backbone/stem|down{s}|res{s}_{i}/c1|c2``, ``h{5,4,3}_a{i}|
b{i}|mid|pre``, ``route5|route4``, each ``_DarkConv``'s ``conv`` and ``bn``,
the biased 1x1 ``h{5,4,3}_out``); ``ssd_from_flax`` for the JAX ``SSD``
(``backbone/stem|stem_bn|block{i}/expand|expand_bn|dw|dw_bn|project|
project_bn|head|head_bn``, the depthwise ``dw`` kernels (3, 3, 1, C) as
(C, 1, 3, 3), ``extra{i}/c1|bn1|c2|bn2``, ``multibox{i}/cls|reg``).

``load_from_flax`` alone loads the segmentors: the JAX ``DeepLabV3Plus``
and ``DeepLabV3`` (``backbone/...`` as above, dilated or not,
``aspp/b0|b1|b2|b3|pool|proj|proj_bn``, ``low_proj``, ``low_bn``,
``dec{i}``, ``dec{i}_bn``, the biased 1x1 ``out``) and ``UNet``
(``down{i}_c{j}|_bn{j}``, ``bottom_c{j}|_bn{j}``, ``dec{i}_c{j}|_bn{j}``,
``out``, and the 2x2 stride-2 ``ConvTranspose`` ``up{i}``, flipped as
every other: SAME at kernel = stride is torch's ``padding=0``).

``adamw_state_from_optax(model, optimizer, opt_state)`` carries the optax
AdamW state of a JAX train state over as well (``mu``, ``nu``, ``count`` ->
``exp_avg``, ``exp_avg_sq``, ``step``), through the same leaf mapping and
the same bijection checks, so a JAX training run resumes in the port;
``sgd_state_from_optax`` does it for the SGD chain's momentum ``trace``
(-> ``momentum_buffer``), also inside the NaN guard's ``apply_if_finite``
state.
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
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                           nn.Linear)) and leaf == "bias":
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


def centerpoint_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``CenterPoint`` or ``CenterPointTwoStage`` variables
    (per-layer RPN layout) into the port's class of the same name."""
    return load_from_flax(model, variables)


def faster_rcnn_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``FasterRCNN`` variables into the port's
    ``FasterRCNN``."""
    return load_from_flax(model, variables)


def mask_rcnn_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``MaskRCNN`` variables into the port's ``MaskRCNN``."""
    return load_from_flax(model, variables)


def yolov8_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOv8`` variables into the port's ``YOLOv8``."""
    return load_from_flax(model, variables)


def yolox_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOX`` variables into the port's ``YOLOX``."""
    return load_from_flax(model, variables)


def yolov5_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOv5`` variables into the port's ``YOLOv5``."""
    return load_from_flax(model, variables)


def yolov3_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOv3`` variables into the port's ``YOLOv3``."""
    return load_from_flax(model, variables)


def yolov4_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOv4`` variables into the port's ``YOLOv4``."""
    return load_from_flax(model, variables)


def yolov7_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``YOLOv7`` variables into the port's ``YOLOv7``."""
    return load_from_flax(model, variables)


def ssd_from_flax(model: nn.Module, variables: Dict) -> nn.Module:
    """Load the JAX ``SSD`` variables into the port's ``SSD``."""
    return load_from_flax(model, variables)


def _states_with(state, fields: Tuple[str, ...]) -> List:
    """Every node of an optax state tree (named tuples) that has
    ``fields``, found by its fields: the port imports no optax."""
    if set(fields) <= set(getattr(state, "_fields", ())):
        return [state]
    if isinstance(state, (tuple, list)):
        return [s for sub in state for s in _states_with(sub, fields)]
    inner = getattr(state, "inner_state", None)
    return [] if inner is None else _states_with(inner, fields)



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
    found = _states_with(opt_state, ("mu", "nu", "count"))
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


@torch.no_grad()
def sgd_state_from_optax(model: nn.Module, optimizer: torch.optim.Optimizer,
                         opt_state) -> torch.optim.Optimizer:
    """Load the reference's ``sgd`` chain state into the port's SGD
    ``optimizer``: the one ``TraceState`` (``trace``, a param-shaped tree)
    into every parameter's ``momentum_buffer``. A schedule's count is not
    carried: an optimizer that runs a schedule raises. Returns
    ``optimizer``."""
    if "count" in optimizer.param_groups[0]:
        raise ValueError("the optimizer runs a schedule, whose count this "
                         "converter does not carry")
    traces = _states_with(opt_state, ("trace",))
    if len(traces) != 1:
        raise ValueError(f"expected one trace in opt_state, found "
                         f"{len(traces)}")
    params = list(model.named_parameters())
    leaves = {("params",) + path: arr
              for path, arr in _flax_leaves(traces[0].trace)}
    buffers = {name: value for name, _, value in _matched(model, params,
                                                          leaves)}
    names = {id(p): n for n, p in params}
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p]["momentum_buffer"] = torch.from_numpy(
                buffers[names[id(p)]]).to(p.device, p.dtype)
    return optimizer
