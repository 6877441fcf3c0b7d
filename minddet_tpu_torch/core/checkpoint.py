"""Checkpoints of torch state dicts (counterpart of
``minddet_tpu/core/checkpoint.py``, which saves through orbax): one
directory per step under the manager's directory, each holding
``state.pt``, a nested dict of tensors and numbers (``torch.save``); the
newest ``keep_max`` steps are kept; with ``async_save`` the host copies
are written by a thread, and ``wait`` joins it.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and copied to the
    CPU, and every numpy array as a tensor (the copy the writer owns; a
    tree loads back as tensors and numbers)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (a nested dict of tensors and numbers) into the
    directory ``path`` as ``state.pt``, through a temporary file, so a
    reader never sees half a file."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def load_pytree(path: str, map_location="cpu") -> Any:
    """The tree ``save_pytree`` wrote into the directory ``path``."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def tree_size_bytes(tree: Any) -> int:
    """Bytes of every tensor and numpy array in ``tree``."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    return 0


class CheckpointManager:
    """Step directories ``directory/<step>`` of ``save_pytree`` trees.

    ``save(step, state)`` writes where ``step`` is a multiple of
    ``save_interval_steps`` (any step with ``force``) and not already
    saved, then removes all but the newest ``keep_max`` steps."""

    def __init__(self, directory: str, keep_max: int = 5,
                 save_interval_steps: int = 1000, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_max = keep_max
        self.save_interval_steps = max(1, save_interval_steps)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` as step ``step``; returns whether it was saved.
        The host copy is made here; with ``async_save`` a thread writes it
        (after the previous write has ended)."""
        self.wait()
        if step in self.all_steps() or not (
                force or step % self.save_interval_steps == 0):
            return False
        host = _to_host(state)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return True

    def _write(self, step: int, host: Any) -> None:
        try:
            save_pytree(self.step_dir(step), host)
            for old in self.all_steps()[:-self.keep_max]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The tree saved at ``step`` (the latest where None)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_pytree(self.step_dir(step), map_location)

    def wait(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
