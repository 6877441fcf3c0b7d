"""Synthetic 2D detection and segmentation batches, and segmentation and
COCO batches from records (counterpart of ``minddet_tpu/train/train.py:
synthetic_detection_batches``, ``synthetic_seg_batches``, ``seg_batches``
and ``coco_batches``).

``synthetic_detection_batch`` is the reference generator's first batch,
draw for draw from numpy ``RandomState(seed)``, with the boxes' slots (and
the bitmaps' channels) padded with empty ones to ``slots``, the padded
width the data pipeline gives a model (the COCO loader's ``max_objs``).
``synthetic_seg_batches`` is the reference's generator, draw for draw.
``coco_batches`` is the COCO pipeline: the host half (``CocoDetection``
through the threaded ``DataLoader``) collates raw batches, and
``coco_device_batch`` runs the device half of each (the affine or the
mosaic + mixup route of ``data/transforms.py``). ``synthetic_coco_records``
makes a COCO-like set of records in memory, images already decoded, for a
host without ``cv2`` or ``array_record``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from minddet_tpu_torch.data.coco import CocoDetection
from minddet_tpu_torch.data.loader import (DataLoader, DistributedSampler,
                                           GroupSampler, aspect_flags,
                                           process_shard)
from minddet_tpu_torch.data.seg import SegDataset
from minddet_tpu_torch.data.transforms import (
    centernet_train_transform_from_draws, draw_mixup, draw_mosaic,
    draw_train_transform, mixup_from_draws, mosaic_from_draws, normalize,
    roll_batch, warp_images)


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


# COCO image sizes (h, w) that the in-memory set draws from: the val set's
# most common shapes and one small one
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427), (640, 640),
              (500, 375))
COCO_CLASSES = 80
COCO_MAX_BOXES = 20       # valid boxes per image: 1 to this (COCO: ~7.3)
COCO_CROWD_SHARE = 0.05   # chance that a box is crowd


def synthetic_coco_records(num_images: int, seed: int = 0,
                           sizes: Sequence[Tuple[int, int]] = COCO_SIZES
                           ) -> List[Dict[str, np.ndarray]]:
    """COCO-like records in memory, from numpy ``RandomState(seed)``: per
    image a size drawn from ``sizes``, 1 to ``COCO_MAX_BOXES`` boxes
    (corners uniform over 85 % of the image, sides 8 px to half the image,
    cut to it), labels among ``COCO_CLASSES``, each box crowd with
    probability ``COCO_CROWD_SHARE``, and the decoded image under
    ``"image"`` ((h, w, 3) uint8: noise with each box painted in its
    class's colour), ids from 1. The records of ``data/coco.py:
    coco_examples`` with the image decoded."""
    rs = np.random.RandomState(seed)
    colours = rs.randint(0, 256, (COCO_CLASSES, 3)).astype(np.uint8)
    records = []
    for i in range(num_images):
        h, w = sizes[rs.randint(len(sizes))]
        n = rs.randint(1, COCO_MAX_BOXES + 1)
        xy = rs.uniform(0, [0.85 * w, 0.85 * h], (n, 2))
        wh = rs.uniform(8, [w / 2, h / 2], (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
        labels = rs.randint(0, COCO_CLASSES, n).astype(np.int32)
        image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for (x1, y1, x2, y2), c in zip(boxes.astype(int), labels):
            image[y1:y2, x1:x2] = colours[c]
        records.append({
            "image": image, "hw": np.array([h, w], np.int32),
            "boxes": boxes.astype(np.float32), "labels": labels,
            "iscrowd": (rs.rand(n) < COCO_CROWD_SHARE).astype(np.int32),
            "image_id": np.asarray(i + 1, np.int64)})
    return records


def draw_coco_batch(generator: torch.Generator, batch_size: int,
                    aug: str = "affine") -> Dict:
    """One batch's draws for ``coco_device_batch``: the train transform's
    (``aug`` "affine"), or {"mosaic", "mixup"} (``aug`` "mosaic")."""
    if aug == "mosaic":
        return {"mosaic": draw_mosaic(generator, batch_size),
                "mixup": draw_mixup(generator, batch_size)}
    return draw_train_transform(generator, batch_size)


def coco_device_batch(raw: Mapping[str, np.ndarray], draws: Dict,
                      image_hw: Tuple[int, int], aug: str = "affine",
                      with_masks: bool = False, mask_stride: int = 4,
                      step: int = 0, device="cuda") -> Dict:
    """The device half of ``coco_batches`` for one raw collated
    ``CocoDetection`` batch (numpy: image in [0, 255], hw, boxes, labels,
    mask, and bitmaps with masks), copied to ``device``.

    "affine": ``centernet_train_transform_from_draws`` (warp, colour,
    normalize; boxes to the output), classes and mask as they are; with
    ``with_masks`` the GT bitmaps warped too, at 1 / ``mask_stride`` of
    both spaces (the image's affine with its translation scaled down:
    x_in / s = A_lin (x_out / s) + A_t / s). "mosaic": ``mosaic`` of the
    [0, 1] images (four warps), ``mixup`` and ``normalize``; boxes, classes
    and mask 8 times the slots. Returns image, gt_boxes, gt_classes,
    gt_mask (and gt_bitmaps), and step."""
    def dev(key):
        return torch.from_numpy(np.asarray(raw[key])).to(device)

    if aug == "mosaic":
        m = mosaic_from_draws(dev("image") / 255.0, dev("hw"), dev("boxes"),
                              dev("mask"), draws["mosaic"], tuple(image_hw))
        labels = dev("labels")
        labels4 = torch.cat([roll_batch(labels, q) for q in range(4)], dim=1)
        mx = mixup_from_draws(m["image"], m["boxes"], m["mask"],
                              draws["mixup"])
        return {"image": normalize(mx["image"]), "gt_boxes": mx["boxes"],
                "gt_classes": torch.cat([labels4, roll_batch(labels4, 1)],
                                        dim=1),
                "gt_mask": mx["mask"], "step": np.asarray(step, np.int32)}
    out = centernet_train_transform_from_draws(
        dev("image"), dev("hw"), dev("boxes"), draws, tuple(image_hw))
    batch = {"image": out["image"], "gt_boxes": out["boxes"],
             "gt_classes": dev("labels"), "gt_mask": dev("mask"),
             "step": np.asarray(step, np.int32)}
    if with_masks:
        aff = out["affine"]
        aff_s = torch.cat([aff[:, :, :2], aff[:, :, 2:] / mask_stride],
                          dim=2)
        batch["gt_bitmaps"] = warp_images(
            dev("bitmaps").float(), aff_s,
            (image_hw[0] // mask_stride, image_hw[1] // mask_stride))
    return batch


def coco_batches(cfg: Mapping, batch_size: int, image_hw: Tuple[int, int],
                 seed: int = 0, aug: str = "affine", device="cuda"
                 ) -> Iterator[Dict]:
    """COCO records -> train batches on ``device``: ``CocoDetection``
    (``cfg["data"]["records"]``: a shard pattern or records in memory;
    ``max_objs`` default 128; ``with_masks``, ``mask_stride`` default 4)
    decoded by ``cfg["data"]["workers"]`` threads (default 4) into this
    process's shard, batch by batch (aspect-pure batches from
    ``GroupSampler`` where ``group_by_aspect``), then ``coco_device_batch``
    on draws from one ``torch.Generator`` seeded with ``seed``; ``step``
    counts from 0. ``aug``: "affine" (CenterNet) or "mosaic" (the YOLO
    configs; not with masks)."""
    dcfg = cfg["data"]
    with_masks = bool(dcfg.get("with_masks", False))
    mask_stride = int(dcfg.get("mask_stride", 4))
    if with_masks and aug == "mosaic":
        raise ValueError("mask training uses the affine pipeline, not mosaic")
    ds = CocoDetection(dcfg["records"], max_objs=dcfg.get("max_objs", 128),
                       with_masks=with_masks, mask_stride=mask_stride)
    shard_id, num_shards = process_shard()
    if dcfg.get("group_by_aspect", False):
        flags = aspect_flags([ds.records[i]["hw"]
                              for i in range(len(ds.records))])
        sampler = GroupSampler(flags, batch_size, num_shards=num_shards,
                               shard_id=shard_id, seed=seed)
    else:
        sampler = DistributedSampler(len(ds), num_shards=num_shards,
                                     shard_id=shard_id, seed=seed)
    loader = DataLoader(ds, batch_size, sampler=sampler,
                        num_workers=dcfg.get("workers", 4))
    generator = torch.Generator().manual_seed(seed)
    for step, raw in enumerate(loader):
        yield coco_device_batch(raw, draw_coco_batch(generator, batch_size,
                                                     aug),
                                image_hw, aug, with_masks, mask_stride, step,
                                device)
