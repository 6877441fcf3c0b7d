"""Evaluation (counterpart of ``minddet_tpu/train/evaluate.py``: so far
``_pad_batch`` and the segmentation mIoU, ``segmentation_evaluate``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from minddet_tpu_torch.data.seg import SegDataset


def _pad_batch(arrays: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a stacked host batch to ``batch_size`` rows by repeating the
    last, so every predict call has one shape; callers keep the real rows
    of the output (the tail images stay in the protocol)."""
    pad = batch_size - arrays.shape[0]
    if pad <= 0:
        return arrays
    return np.concatenate([arrays, np.repeat(arrays[-1:], pad, axis=0)], 0)


@torch.no_grad()
def segmentation_evaluate(model: nn.Module, records: str, num_classes: int,
                          batch_size: int = 8, max_images: int = 0
                          ) -> Dict[str, float]:
    """mIoU of ``model.predict`` over segmentation records (``SegDataset``
    without augmentation: the train path's normalization; ignored pixels
    left out): per class, intersection and union summed over the dataset
    (the first ``max_images`` where positive), their ratio averaged over
    the classes present in either. Batches of ``batch_size``, the tail
    padded (``_pad_batch``), run on the model's device as it is (eval
    mode for served weights)."""
    ds = SegDataset(records, augment=False)
    n = min(len(ds), max_images) if max_images else len(ds)
    dev = next(model.parameters()).device
    inter = np.zeros(num_classes)
    union = np.zeros(num_classes)
    for start in range(0, n, batch_size):
        recs = [ds[i] for i in range(start, min(start + batch_size, n))]
        images = _pad_batch(np.stack([r["image"] for r in recs]), batch_size)
        pred = model.predict(torch.from_numpy(images).to(dev))
        pred = pred[: len(recs)].cpu().numpy()
        target = np.stack([r["mask"] for r in recs])
        valid = np.stack([r["valid"] for r in recs])
        for c in range(num_classes):
            inter[c] += np.sum((pred == c) & (target == c) & valid)
            union[c] += np.sum(((pred == c) | (target == c)) & valid)
    per_class = inter / np.maximum(union, 1)
    present = union > 0
    return {"miou": float(per_class[present].mean()) if present.any()
            else 0.0}
