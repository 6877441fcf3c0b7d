"""Synthetic 2D detection and segmentation batches, and segmentation
batches from records (counterpart of ``minddet_tpu/train/train.py:
synthetic_detection_batches``, ``synthetic_seg_batches`` and
``seg_batches``).

``synthetic_detection_batch`` is the reference generator's first batch,
draw for draw from numpy ``RandomState(seed)``, with the boxes' slots (and
the bitmaps' channels) padded with empty ones to ``slots``, the padded
width the data pipeline gives a model (the COCO loader's ``max_objs``).
``synthetic_seg_batches`` is the reference's generator, draw for draw.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from minddet_tpu_torch.data.loader import (DataLoader, DistributedSampler,
                                           process_shard)
from minddet_tpu_torch.data.seg import SegDataset


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


def synthetic_seg_batches(batch_size: int, image_hw: Tuple[int, int],
                          num_classes: int, seed: int = 0
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Random images with blocky class masks, batch after batch from one
    ``RandomState(seed)``: a coarse 8 x 8 grid of classes upsampled to the
    image (contiguous regions), the image uniform [0, 1) plus a
    class-dependent hue (so the mask can be read from the pixels), valid
    everywhere, ``step`` counting from 1. Not normalized: the reference's
    synthetic runs feed it as it is."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    step = 0
    while True:
        step += 1
        coarse = rng.randint(0, num_classes, (batch_size, 8, 8))
        mask = np.repeat(np.repeat(coarse, -(-h // 8), 1), -(-w // 8), 2)
        mask = mask[:, :h, :w].astype(np.int32)
        image = rng.rand(batch_size, h, w, 3).astype(np.float32)
        image += 0.5 * np.stack(
            [np.cos(mask * 2.1), np.sin(mask * 1.3), np.cos(mask * 0.7)], -1)
        yield {"image": image.astype(np.float32), "mask": mask,
               "valid": np.ones((batch_size, h, w), bool),
               "step": np.asarray(step, np.int32)}


def seg_batches(cfg: Mapping, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Segmentation records -> normalized image, mask and valid batches
    (``data/seg.py:SegDataset``, flipped where ``cfg["data"]["augment"]``,
    default on), this process's shard (``data/loader.py:process_shard``),
    ``cfg["data"]["workers"]`` threads (default 4), ``step`` counting from
    0. ``cfg`` is a config mapping as its YAML file loads, with
    ``data.records`` the shards' pattern."""
    dcfg = cfg["data"]
    ds = SegDataset(dcfg["records"], augment=bool(dcfg.get("augment", True)),
                    seed=seed)
    shard_id, num_shards = process_shard()
    sampler = DistributedSampler(len(ds), num_shards=num_shards,
                                 shard_id=shard_id, seed=seed)
    loader = DataLoader(ds, batch_size, sampler=sampler,
                        num_workers=dcfg.get("workers", 4))
    for step, raw in enumerate(loader):
        raw["step"] = np.asarray(step, np.int32)
        yield raw
