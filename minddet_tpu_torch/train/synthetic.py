"""Synthetic 2D detection batches (counterpart of
``minddet_tpu/train/train.py:synthetic_detection_batches``).

``synthetic_detection_batch`` is the reference generator's first batch,
draw for draw from numpy ``RandomState(seed)``, with the boxes' slots (and
the bitmaps' channels) padded with empty ones to ``slots``, the padded
width the data pipeline gives a model (the COCO loader's ``max_objs``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def synthetic_detection_batch(batch_size: int, image_hw: Tuple[int, int],
                              num_classes: int, max_objs: int = 16,
                              seed: int = 0, with_masks: bool = False,
                              mask_stride: int = 4,
                              slots: Optional[int] = None
                              ) -> Dict[str, np.ndarray]:
    """Images uniform in [0, 1) (B, H, W, 3) f32, per image 2 to
    ``max_objs`` - 1 boxes (top-left corners uniform over 70 % of the
    image, sides 5-30 % of it) in ``slots`` slots (``max_objs`` where not
    given), random 0-based classes in every drawn slot (0 in the padding),
    the mask of the valid slots; with ``with_masks`` also ``gt_bitmaps``
    (B, H / s, W / s, slots) f32: each box's inscribed ellipse at 1 / s of
    the image's resolution. Returns image, gt_boxes, gt_classes, gt_mask
    (and gt_bitmaps)."""
    slots = max_objs if slots is None else slots
    if slots < max_objs:
        raise ValueError(f"{slots} slots cannot hold {max_objs} drawn ones")
    rng = np.random.RandomState(seed)
    h, w = image_hw
    n = rng.randint(2, max_objs, batch_size)
    boxes = np.zeros((batch_size, slots, 4), np.float32)
    classes = np.zeros((batch_size, slots), np.int32)
    classes[:, :max_objs] = rng.randint(0, num_classes,
                                        (batch_size, max_objs))
    mask = np.zeros((batch_size, slots), bool)
    for i in range(batch_size):
        xy = rng.uniform(0, [w * 0.7, h * 0.7], (n[i], 2))
        wh = rng.uniform([w * 0.05, h * 0.05], [w * 0.3, h * 0.3], (n[i], 2))
        boxes[i, :n[i]] = np.concatenate([xy, xy + wh], -1)
        mask[i, :n[i]] = True
    out = {"image": rng.rand(batch_size, h, w, 3).astype(np.float32),
           "gt_boxes": boxes, "gt_classes": classes, "gt_mask": mask}
    if with_masks:
        s = mask_stride
        bm = np.zeros((batch_size, h // s, w // s, slots), np.float32)
        yy, xx = np.mgrid[: h // s, : w // s]
        for i in range(batch_size):
            for o in range(n[i]):
                x1, y1, x2, y2 = boxes[i, o] / s
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                rx = max((x2 - x1) / 2, 1e-3)
                ry = max((y2 - y1) / 2, 1e-3)
                bm[i, :, :, o] = (((xx - cx) / rx) ** 2
                                  + ((yy - cy) / ry) ** 2 <= 1.0)
        out["gt_bitmaps"] = bm
    return out
