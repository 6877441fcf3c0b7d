"""2D anchors of the R-CNN family (counterpart of ``grid_anchors`` and
``multilevel_anchors`` in ``minddet_tpu/ops/anchors2d.py``).

Anchors are static: numpy grids computed once when a model is built, which
the model keeps as a device buffer. Boxes are [x1, y1, x2, y2] in input
pixels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def grid_anchors(feature_hw: Tuple[int, int], stride: int,
                 scales: Sequence[float] = (8.0,),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """(H * W * A, 4) f32 anchors of one level, position-major (row, then
    column, then anchor): centres at (i + 0.5) * stride, for each scale s
    and ratio r a box of s * stride * (sqrt(1 / r), sqrt(r))."""
    h, w = feature_hw
    base = []
    for s in scales:
        for r in ratios:
            size = s * stride
            bw = size * np.sqrt(1.0 / r)
            bh = size * np.sqrt(r)
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    base = np.asarray(base, np.float32)
    ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
    xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def level_shape(image_hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """A pyramid level's (H, W): the image's sides over the stride, rounded
    up."""
    return -(-image_hw[0] // stride), -(-image_hw[1] // stride)


def multilevel_anchors(image_hw: Tuple[int, int], strides: Sequence[int],
                       scales: Sequence[float] = (8.0,),
                       ratios: Sequence[float] = (0.5, 1.0, 2.0),
                       scales_per_level: Optional[Sequence[Sequence[float]]]
                       = None) -> np.ndarray:
    """Every level's ``grid_anchors`` concatenated -> (A_total, 4); a level
    takes ``scales_per_level[i]`` where given, else ``scales``."""
    out = []
    for li, s in enumerate(strides):
        sc = scales_per_level[li] if scales_per_level is not None else scales
        out.append(grid_anchors(level_shape(image_hw, s), s, sc, ratios))
    return np.concatenate(out, axis=0)
