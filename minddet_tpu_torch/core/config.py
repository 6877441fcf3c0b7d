"""The configuration system (counterpart of ``minddet_tpu/core/config.py``):
an attribute-access dict (``ConfigDict``), a loader for .yaml (several
documents merged in order), .json and .py files with ``_base_``
inheritance (``Config.fromfile``), and dotted-key command-line overrides
(``Config.merge_from_options``). Host Python only; the port keeps its own
copy.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys
from typing import Any, Dict, Iterable, Mapping, Optional


class ConfigDict(dict):
    """Dict with attribute access that recursively wraps nested mappings."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in args + (kwargs,):
            if src is None:
                continue
            for k, v in dict(src).items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, Mapping):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"ConfigDict has no attribute {key!r}")

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key)

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        def _unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: _unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_unwrap(x) for x in v)
            return v

        return {k: _unwrap(v) for k, v in self.items()}


def _merge_dict(base: ConfigDict, override: Mapping) -> ConfigDict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    for k, v in override.items():
        if (k in base and isinstance(base[k], Mapping)
                and isinstance(v, Mapping)):
            _merge_dict(base[k], v)
        else:
            base[k] = v
    return base


def _parse_scalar(text: str) -> Any:
    """Best-effort parse of a command-line override's value: booleans,
    none / null, int, float, a bracketed or comma-separated list, else the
    string."""
    lowered = text.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.startswith("[") and text.endswith("]"):  # [0.4,0.4,8.0]
        text = text[1:-1]
        return [_parse_scalar(t.strip()) for t in text.split(",") if t.strip()]
    if "," in text:
        return [_parse_scalar(t) for t in text.split(",") if t]
    return text


class Config:
    """A loaded configuration: a ConfigDict and the file it came from."""

    def __init__(self, cfg_dict: Optional[Mapping] = None,
                 filename: Optional[str] = None):
        self._cfg = ConfigDict(cfg_dict or {})
        self._filename = filename

    @staticmethod
    def fromfile(filename: str) -> "Config":
        """Load a .yaml / .yml (every document merged in order), .json or
        .py (its public module-level values) file; a ``_base_`` key (a path
        or a list, relative to the file) merges those files under it."""
        filename = os.path.abspath(os.path.expanduser(str(filename)))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        ext = os.path.splitext(filename)[1]
        if ext in (".yaml", ".yml"):
            import yaml

            with open(filename) as f:
                docs = list(yaml.safe_load_all(f))
            merged_yaml = ConfigDict()
            for doc in docs:
                if doc:
                    _merge_dict(merged_yaml, doc)
            cfg: Dict[str, Any] = merged_yaml
        elif ext == ".json":
            with open(filename) as f:
                cfg = json.load(f)
        elif ext == ".py":
            cfg = _load_py_config(filename)
        else:
            raise ValueError(f"Unsupported config extension: {ext}")
        out = Config(cfg, filename=filename)
        base = out._cfg.pop("_base_", None)
        if base:
            bases = base if isinstance(base, (list, tuple)) else [base]
            merged = ConfigDict()
            for b in bases:
                bpath = os.path.join(os.path.dirname(filename), b)
                _merge_dict(merged, Config.fromfile(bpath)._cfg)
            _merge_dict(merged, out._cfg)
            out._cfg = merged
        return out

    @staticmethod
    def fromdict(d: Mapping) -> "Config":
        return Config(d)

    def merge_from_dict(self, override: Mapping) -> "Config":
        _merge_dict(self._cfg, override)
        return self

    def merge_from_options(self, options: Iterable[str]) -> "Config":
        """Apply ``["a.b.c=1", "model.depth=50"]`` style overrides."""
        for opt in options:
            key, _, raw = opt.partition("=")
            if not _:
                raise ValueError(f"Override must be key=value, got {opt!r}")
            node = self._cfg
            parts = key.strip().split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = ConfigDict()
                node = node[p]
            node[parts[-1]] = _parse_scalar(raw.strip())
        return self

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return getattr(self._cfg, key)

    def __getitem__(self, key):
        return self._cfg[key]

    def __contains__(self, key):
        return key in self._cfg

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    def keys(self):
        return self._cfg.keys()

    def to_dict(self) -> Dict[str, Any]:
        return self._cfg.to_dict()

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    def __repr__(self):
        return f"Config(file={self._filename}, keys={sorted(self._cfg)})"


def _load_py_config(filename: str) -> Dict[str, Any]:
    """Run a .py config file and collect its public module-level values
    (not callables or modules), without leaving it in ``sys.modules``."""
    module_name = ("_minddet_tpu_torch_cfg_"
                   + os.path.splitext(os.path.basename(filename))[0])
    spec = importlib.util.spec_from_file_location(module_name, filename)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    try:
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        return {
            k: v
            for k, v in vars(mod).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(sys))
        }
    finally:
        sys.modules.pop(module_name, None)
