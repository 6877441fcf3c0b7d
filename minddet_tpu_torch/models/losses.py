"""Losses of the port (counterpart of ``minddet_tpu/models/losses.py``).

Only ``sigmoid_clip`` so far, which the CenterNet heatmap head uses; the
training losses come with the training step.
"""

from __future__ import annotations

import torch


def sigmoid_clip(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1 - eps] so log() is safe."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)
