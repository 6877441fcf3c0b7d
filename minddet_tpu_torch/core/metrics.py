"""Structured metrics, step timing and logging (counterpart of
``minddet_tpu/core/metrics.py``): a JSONL metric writer with the
reference's record keys, a per-step timer, and ``profiler_trace``, a
``torch.profiler`` context that writes a Chrome trace.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

logger = logging.getLogger("minddet_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class MetricWriter:
    """Append-only JSONL metrics: per record ``step``, ``time`` (seconds
    since the writer was made, to the millisecond) and the metrics, numbers
    as floats (tensors through ``.item()``)."""

    def __init__(self, log_dir: Optional[str] = None,
                 filename: str = "metrics.jsonl"):
        self._path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, filename)
        self._t0 = time.time()

    @property
    def path(self) -> Optional[str]:
        return self._path

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        record.update(
            {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                 else v)
             for k, v in metrics.items()})
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(record) + "\n")
        logger.info(
            "step %d | %s", step,
            " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in record.items() if k != "step"))


class StepTimer:
    """Per-step wall time and images a second after ``warmup_steps``
    steps (the reference's ``TimeMonitor``)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._total = 0.0
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per completed step; returns this step's duration."""
        now = time.perf_counter()
        dur = None
        if self._last is not None:
            dur = now - self._last
            self._count += 1
            if self._count > self.warmup:
                self._total += dur
        self._last = now
        return dur

    @property
    def mean_step_time(self) -> float:
        n = max(self._count - self.warmup, 1)
        return self._total / n if self._total else float("nan")

    def throughput(self, batch_size: int) -> float:
        st = self.mean_step_time
        return batch_size / st if st and st == st else float("nan")


@contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, and CUDA where the card is
    there), its Chrome trace written to ``log_dir/trace.json``; no-op if
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
