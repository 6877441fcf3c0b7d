"""Model export: predict programs through ``torch.export`` (counterpart of
``minddet_tpu/train/export.py``).

The reference lowers a jitted predict to StableHLO with ``jax.export`` at
fixed shapes and serializes it, the role of the original MINDIR export
(``centernet/export.py``, ``centerpoint/tools_ms/mindir.py``). Here
``torch.export.export`` traces the predict at the example inputs' shapes
into an ``ExportedProgram`` that holds the model's weights, and
``torch.export.save`` writes it as a ``.pt2`` file; ``load_exported``
reloads it and runs it without the model's code.

Every hand-written kernel is a ``torch.library`` custom op (the
``minddet::`` namespace), so the traced graph keeps each kernel as one op
node (``exported_ops`` counts them) and never traces into it: a reloaded
program on the GPU launches the same kernels as the live model and bumps
the same launch counts. The ops are registered when their modules are
imported, which ``load_exported_program`` does before it loads. The greedy
NMS's fixed point is traced as a ``while_loop`` (``ops/nms.py``).

The port's models hold their weights, so there is no ``variables``
argument. A program runs on the device it was exported on.
"""

from __future__ import annotations

import collections
import functools
import importlib
import os
from typing import Any, Callable, Counter, List, NamedTuple, Sequence

import torch
from torch import nn

from minddet_tpu_torch.kernels import OP_MODULES

OP_NAMESPACE = "minddet"


def load_ops() -> None:
    """Registers every ``minddet::`` op (imports their modules)."""
    for name in OP_MODULES:
        importlib.import_module(name)


class _Program(nn.Module):
    """``fn`` as a module to export. Where ``fn`` is a model's method (or a
    ``functools.partial`` of one), the model is registered, so that its
    weights are the program's state, not constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn
        owner = getattr(getattr(fn, "func", fn), "__self__", None)
        self.owner = owner if isinstance(owner, nn.Module) else None

    def forward(self, *args):
        return self.fn(*args)


def export_predict_fn(fn: Callable, example_args: Sequence[Any],
                      path: str) -> str:
    """Trace ``fn(*example_args)`` with ``torch.export.export`` under
    ``torch.no_grad()`` and write it to ``path`` (a ``.pt2`` file). The
    shapes are fixed at the example args' shapes, as the reference's
    fixed-shape export. Returns the path."""
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), tuple(example_args),
                                 strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.export.save(ep, path)
    return path


class InputSpec(NamedTuple):
    """One input of an exported program: its fixed shape, type, device."""
    shape: torch.Size
    dtype: torch.dtype
    device: torch.device


def input_specs(ep: torch.export.ExportedProgram) -> List[InputSpec]:
    """The user inputs' specs of ``ep``, in order (the reference's
    ``in_avals``)."""
    user = set(ep.graph_signature.user_inputs)
    return [InputSpec(n.meta["val"].shape, n.meta["val"].dtype,
                      n.meta["val"].device)
            for n in ep.graph.nodes if n.op == "placeholder"
            and n.name in user]


def exported_ops(ep: torch.export.ExportedProgram) -> Counter[str]:
    """How many nodes of each ``minddet::`` op the program's graph holds,
    its nested graphs (the NMS's ``while_loop``) included."""
    found: Counter[str] = collections.Counter()
    modules = [ep.graph_module]
    while modules:
        gm = modules.pop()
        for node in gm.graph.nodes:
            target = node.target
            if isinstance(target, torch._ops.OpOverload) \
                    and target.namespace == OP_NAMESPACE:
                found[target._opname] += 1
        modules.extend(m for m in gm.children()
                       if isinstance(m, torch.fx.GraphModule))
    return found


def load_exported(path: str) -> Callable:
    """Reload a saved program -> callable (the reference's eval_mindir
    role)."""
    return load_exported_program(path)[0]


def load_exported_program(path: str):
    """Reload a saved program -> (callable, input specs). The specs carry
    the fixed export shapes, so a consumer (``evaluate.py --exported``)
    reads batch and resolution from the artifact. The callable runs the
    program under ``torch.no_grad()``."""
    load_ops()
    ep = torch.export.load(path)
    module = ep.module()

    @torch.no_grad()
    def run(*args):
        return module(*args)

    return run, input_specs(ep)


def export_detector(model: nn.Module, example_image: torch.Tensor,
                    path: str, **predict_kwargs) -> str:
    """Export a zoo detector's fused predict (forward, decode, NMS) at the
    example image's (B, H, W, 3) shape, from ``model`` in eval mode."""
    model.eval()
    fn = functools.partial(model.predict, **predict_kwargs)
    return export_predict_fn(fn, (example_image,), path)


def export_detector_3d(model: nn.Module, example_points: torch.Tensor,
                       example_mask: torch.Tensor, path: str,
                       refined: bool = False, **predict_kwargs) -> str:
    """Export a points model's fused predict (voxelize, forward, decode,
    NMS) at fixed point-capacity shapes: ``predict_from_points`` or, with
    ``refined``, the two-stage ``predict_refined``. The raw padded cloud is
    the fixed shape and voxelization is part of the program, as in the
    reference."""
    model.eval()
    method = model.predict_refined if refined else model.predict_from_points
    fn = functools.partial(method, **predict_kwargs)
    return export_predict_fn(fn, (example_points, example_mask), path)
