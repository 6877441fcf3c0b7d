"""The component registry (counterpart of ``minddet_tpu/core/registry.py``):
``Registry``, ``build_from_cfg`` and the twelve shared registries. The
port's models, losses, datasets, optimizers and schedules are registered
under the reference's names (``models/zoo.py``, ``core/optim.py``,
``core/lr_schedules.py``), so ``DETECTORS.build(cfg.model)`` takes a
config's model section as the reference does.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/function registry.

    Usage::

        BACKBONES = Registry("backbones")

        @BACKBONES.register_module()
        class ResNet(nn.Module):
            ...

        net = BACKBONES.build({"type": "ResNet", "depth": 18})
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return dict(self._module_dict)

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return (f"Registry(name={self._name}, "
                f"items={sorted(self._module_dict)})")

    def get(self, key: str) -> Any:
        if key not in self._module_dict:
            raise KeyError(
                f"{key!r} is not registered in {self._name!r}. "
                f"Available: {sorted(self._module_dict)}"
            )
        return self._module_dict[key]

    def register_module(
        self, name: Optional[str] = None, module: Optional[Any] = None,
        force: bool = False
    ) -> Callable:
        """Register a class or function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool) -> None:
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(
                f"module must be a class or function, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key!r} already registered in {self._name!r}")
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        return build_from_cfg(cfg, self, **default_kwargs)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   **default_kwargs) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type)``.

    ``cfg`` may be any mapping with a ``type`` key (string name or the class
    itself). ``default_kwargs`` fill in keys absent from ``cfg``.
    """
    if not hasattr(cfg, "keys"):
        raise TypeError(f"cfg must be a mapping, got {type(cfg)}")
    if "type" not in cfg:
        raise KeyError(f"cfg must contain the key 'type': {cfg}")
    args = {k: v for k, v in dict(cfg).items() if k != "type"}
    for k, v in default_kwargs.items():
        args.setdefault(k, v)
    obj_type = cfg["type"]
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"'type' must be a str or class, got {type(obj_type)}")
    return obj_cls(**args)


# The shared registries, the reference's twelve.
READERS = Registry("readers")
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
LOSSES = Registry("losses")
DETECTORS = Registry("detectors")
SECOND_STAGE = Registry("second_stage")
ROI_HEAD = Registry("roi_head")
DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")
OPTIMIZERS = Registry("optimizers")
LR_SCHEDULES = Registry("lr_schedules")
