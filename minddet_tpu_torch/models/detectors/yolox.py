"""The helper of ``minddet_tpu/models/detectors/yolox.py`` that the YOLO
detectors share, ``yolo_grid``; the port keeps its own copy (its ``_bce``
is ``models/losses.py:bce_with_logits``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def yolo_grid(image_hw: Tuple[int, int], strides: Sequence[int] = (8, 16, 32)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The anchor points of every level, concatenated: centres (A, 2) xy in
    pixels, ((x + 0.5) s, (y + 0.5) s) row-major, and strides (A,), both
    f32."""
    pts, sts = [], []
    ih, iw = image_hw
    for s in strides:
        fh, fw = ih // s, iw // s
        ys, xs = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
        p = np.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2)
        pts.append(p.astype(np.float32))
        sts.append(np.full((len(p),), s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)

