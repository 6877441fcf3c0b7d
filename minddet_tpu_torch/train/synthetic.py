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
host without ``cv2`` or ``array_record``. ``kitti_batches`` is the KITTI
pipeline's host half (the GT database, ``KittiDetection`` with the
sampler, the per-object noise and the global augmentation, the threaded
loader); ``synthetic_kitti_records`` makes KITTI-like frames in memory.
``nuscenes_batches`` is the nuScenes pipeline's host half (the GT database,
``NuScenesDetection`` with CBGS, the sampler and the global augmentation,
the threaded loader); ``synthetic_nuscenes_records`` makes nuScenes-like
keyframes in memory, scenes of moving objects seen from a moving car.
``waymo_batches`` is the Waymo pipeline's host half (the GT database,
``WaymoDetection`` with the sampler and the global augmentation, the
threaded loader); ``synthetic_waymo_records`` makes Waymo-like frames in
memory, a 64-beam top lidar's returns around vehicles, pedestrians and
cyclists.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from minddet_tpu_torch.data.coco import CocoDetection
from minddet_tpu_torch.data.gt_sampler import (DataBaseSampler,
                                               build_gt_database,
                                               load_database)
from minddet_tpu_torch.data.kitti import (KittiDetection,
                                          detections_to_kitti_annos)
from minddet_tpu_torch.data.loader import (DataLoader, DistributedSampler,
                                           GroupSampler, aspect_flags,
                                           process_shard)
from minddet_tpu_torch.data.nuscenes import (DETECTION_CLASSES,
                                             TRACKING_KEYS,
                                             NuScenesDetection,
                                             infer_attributes)
from minddet_tpu_torch.data.seg import SegDataset
from minddet_tpu_torch.data.waymo import (WAYMO_CLASSES, WaymoDetection,
                                          waymo_frame_to_example)
from minddet_tpu_torch.ops import host_ops
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


def kitti_batches(cfg: Mapping, batch_size: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """KITTI records -> raw host batches (points, points_mask, gt_boxes,
    gt_classes, gt_mask; ``step`` counting from 0), the reference's
    recipe: the GT database loaded from ``gt_sampler.database`` where that
    file exists, else built from the train records; ``DataBaseSampler``
    (``max_per_class``, default {Car: 15}), ``KittiDetection``
    (``max_points`` 20000, ``max_gt`` 40, ``object_noise``, ``augment``
    on, by default) seeded with ``seed``, this process's shard and
    ``cfg["data"]["workers"]`` threads (default 4). Voxelization, the
    anchor mask and the assignment run on the device in the train step.
    ``cfg`` is a configuration mapping as its YAML file loads, with
    ``data.records`` a shard pattern or records in memory."""
    dcfg = cfg["data"]
    classes = tuple(dcfg.get("classes", ("Car",)))
    class_ids = {c: i + 1 for i, c in enumerate(classes)}
    sampler_obj = None
    scfg = dcfg.get("gt_sampler")
    if scfg:
        path = scfg.get("database")
        if path and os.path.exists(path):
            db = load_database(path)
        else:
            db = build_gt_database(KittiDetection(dcfg["records"]), classes)
        sampler_obj = DataBaseSampler(
            db, {str(k): int(v) for k, v in dict(scfg.get(
                "max_per_class", {"Car": 15})).items()}, class_ids)
    noise = dcfg.get("object_noise", {})
    ds = KittiDetection(
        dcfg["records"], max_points=int(dcfg.get("max_points", 20000)),
        max_gt=int(dcfg.get("max_gt", 40)), gt_sampler=sampler_obj,
        augment=bool(dcfg.get("augment", True)),
        object_noise=dict(noise) if noise is not None else None, seed=seed)
    shard_id, num_shards = process_shard()
    sampler = DistributedSampler(len(ds), num_shards=num_shards,
                                 shard_id=shard_id, seed=seed)
    loader = DataLoader(ds, batch_size, sampler=sampler,
                        num_workers=dcfg.get("workers", 4))
    for step, raw in enumerate(loader):
        raw["step"] = np.asarray(step, np.int32)
        yield raw


# KITTI-like frames: the camera of tests/test_3d_data.py (camera x = -y,
# y = -z (down), z = x of the lidar; 500 px focal length) on KITTI's image
KITTI_P2 = np.array([[500.0, 0, 600, 0], [0, 500, 180, 0], [0, 0, 1, 0]],
                    np.float32)
KITTI_TRV2C_RECT = np.array([[0, -1, 0, 0], [0, 0, -1, 0.08],
                             [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
KITTI_IMG_SHAPE = (375, 1242)
# (w, l, h) of each labelled class, jittered by ~10 % per object
KITTI_OBJECT_SIZES = {"Car": (1.6, 3.9, 1.56), "Van": (1.9, 5.0, 2.1),
                      "Pedestrian": (0.6, 0.8, 1.73),
                      "Cyclist": (0.6, 1.76, 1.73)}
KITTI_POINTS = (16000, 26000)  # points per frame, drawn in this range
KITTI_MAX_OBJECTS = 12     # labelled objects per frame: 1 to this
KITTI_GROUND_Z = -1.73     # the lidar's height over the road
KITTI_DONTCARE_SHARE = 0.5  # frames with one or two DontCare regions


def _kitti_objects(rs: np.random.RandomState, n: int):
    """Up to ``n`` non-overlapping (in BEV) objects in the camera's view:
    names, (k, 7) lidar boxes [x, y, z_bottom, w, l, h, yaw]."""
    names = list(KITTI_OBJECT_SIZES)
    kinds = rs.choice(len(names), n, p=[0.5, 0.1, 0.25, 0.15])
    chosen, boxes = [], np.zeros((0, 7), np.float32)
    for k in kinds:
        w, l, h = np.asarray(KITTI_OBJECT_SIZES[names[k]]) * np.exp(
            0.1 * rs.randn(3))
        for _ in range(20):
            x = rs.uniform(4.0, 45.0)
            y = rs.uniform(-1, 1) * min(0.8 * x, 18.0)
            box = np.array([[x, y, KITTI_GROUND_Z + 0.05 * rs.randn(), w, l,
                             h, rs.uniform(-np.pi, np.pi)]], np.float32)
            bev = box[:, [0, 1, 3, 4, 6]]
            if len(boxes) and host_ops.rotated_iou_matrix(
                    bev, boxes[:, [0, 1, 3, 4, 6]]).max() > 0:
                continue
            chosen.append(names[k])
            boxes = np.concatenate([boxes, box])
            break
    return chosen, boxes


def synthetic_kitti_records(num_frames: int, seed: int = 0,
                            classes: Sequence[str] = ("Car",)
                            ) -> List[Dict[str, np.ndarray]]:
    """KITTI-like frames in memory, from numpy ``RandomState(seed)``, in
    the layout of ``data/kitti.py:kitti_examples``: per frame 1 to
    ``KITTI_MAX_OBJECTS`` labelled objects (Car, Van, Pedestrian, Cyclist)
    in the camera's view, 4-45 m ahead, apart in BEV, with 20-400 points
    inside each (fewer the farther), and a road of points out to 80 m and
    50 m aside with some clutter up to 2 m over it, so that some points lie
    outside any configuration's range; ``KITTI_POINTS`` points in all
    (some frames over the loader's 20000). The labels are camera-frame
    annos through ``detections_to_kitti_annos`` with ``KITTI_P2`` and
    ``KITTI_TRV2C_RECT``, occlusion 0-2 and truncation 0-0.5 drawn so that
    all three difficulties occur, and in half the frames one or two
    DontCare rows (location -1000, dimensions -1). ``gt_boxes`` and
    ``gt_classes`` (1-based) hold the objects of ``classes``."""
    rs = np.random.RandomState(seed)
    class_ids = {c: i + 1 for i, c in enumerate(classes)}
    names_all = tuple(KITTI_OBJECT_SIZES)
    records = []
    for f in range(num_frames):
        names, boxes = _kitti_objects(rs, rs.randint(1, KITTI_MAX_OBJECTS
                                                     + 1))
        total = rs.randint(*KITTI_POINTS)
        obj_pts = []
        for b in boxes:
            k = int(np.clip(8000 / b[0], 20, 400))
            u = rs.uniform(-0.5, 0.5, (k, 3))
            c, s = np.cos(b[6]), np.sin(b[6])
            dx, dy = u[:, 0] * b[3], u[:, 1] * b[4]
            obj_pts.append(np.stack([b[0] + c * dx - s * dy,
                                     b[1] + s * dx + c * dy,
                                     b[2] + (u[:, 2] + 0.5) * b[5],
                                     rs.rand(k)], -1))
        rest = total - sum(len(p) for p in obj_pts)
        clutter = rest // 5
        ground = rest - clutter
        bg = np.stack([rs.uniform(-5, 80, rest), rs.uniform(-50, 50, rest),
                       np.concatenate([KITTI_GROUND_Z + 0.05 * rs.randn(
                           ground), rs.uniform(KITTI_GROUND_Z, 2.0,
                                               clutter)]),
                       rs.rand(rest)], -1)
        points = np.concatenate(obj_pts + [bg]).astype(np.float32)
        points = points[rs.permutation(len(points))]
        labels = np.array([names_all.index(n) for n in names])
        anno = detections_to_kitti_annos(
            boxes, np.ones(len(boxes), np.float32), labels, names_all,
            KITTI_TRV2C_RECT, KITTI_P2, KITTI_IMG_SHAPE)
        if len(anno["name"]) != len(boxes):
            raise AssertionError("an object left the camera's view")
        n = len(boxes)
        occluded = rs.choice(3, n, p=[0.5, 0.3, 0.2]).astype(np.int64)
        truncated = np.where(rs.rand(n) < 0.6, 0.0, rs.uniform(0, 0.5, n)
                             ).astype(np.float32)
        dc = rs.randint(1, 3) if rs.rand() < KITTI_DONTCARE_SHARE else 0
        dc_xy = rs.uniform([0, 150], [1100, 250], (dc, 2))
        dc_bbox = np.concatenate(
            [dc_xy, dc_xy + rs.uniform([20, 10], [120, 60], (dc, 2))], 1)
        keep = np.array([nm in class_ids for nm in names], bool)
        records.append({
            "points": points,
            "gt_boxes": boxes[keep].astype(np.float32),
            "gt_classes": np.array([class_ids[nm] for nm in names
                                    if nm in class_ids], np.int32),
            "frame_id": np.frombuffer(f"{f:06d}".encode().ljust(16),
                                      np.uint8).copy(),
            "P2": KITTI_P2,
            "Trv2c_rect": KITTI_TRV2C_RECT,
            "img_shape": np.asarray(KITTI_IMG_SHAPE, np.int32),
            "anno_name": np.array(list(anno["name"]) + ["DontCare"] * dc,
                                  dtype="U16"),
            "anno_bbox": np.concatenate([anno["bbox"], dc_bbox]).astype(
                np.float32),
            "anno_alpha": np.concatenate([anno["alpha"], np.full(dc, -10.0)]
                                         ).astype(np.float32),
            "anno_occluded": np.concatenate([occluded, np.full(dc, -1)]
                                            ).astype(np.int64),
            "anno_truncated": np.concatenate([truncated, np.full(dc, -1.0)]
                                             ).astype(np.float32),
            "anno_location": np.concatenate([anno["location"],
                                             np.full((dc, 3), -1000.0)]
                                            ).astype(np.float32),
            "anno_dimensions": np.concatenate([anno["dimensions"],
                                               np.full((dc, 3), -1.0)]
                                              ).astype(np.float32),
            "anno_rotation_y": np.concatenate([anno["rotation_y"],
                                               np.full(dc, -10.0)]
                                              ).astype(np.float32),
        })
    return records


def nuscenes_batches(cfg: Mapping, batch_size: int, seed: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """nuScenes records -> raw host batches (points, points_mask, gt_boxes,
    gt_classes, gt_mask; ``step`` counting from 0), the reference's recipe:
    the GT database loaded from ``gt_sampler.database`` where that file
    exists, else built from the train records with the config's per-class
    ``min_points`` (default 5); ``DataBaseSampler`` (``max_per_class``,
    default {car: 2}); ``NuScenesDetection`` (``max_points`` 120000,
    ``max_gt`` 500, ``cbgs`` and ``augment`` on, by default) seeded with
    ``seed``, this process's shard and ``cfg["data"]["workers"]`` threads
    (default 4). The attributes and the tracking keys are left out of the
    batch (they feed the evaluations, not the loss). ``cfg`` is a
    configuration mapping as its YAML file loads, with ``data.records`` a
    shard pattern or records in memory."""
    dcfg = cfg["data"]
    sampler_obj = None
    scfg = dcfg.get("gt_sampler")
    if scfg:
        path = scfg.get("database")
        if path and os.path.exists(path):
            db = load_database(path)
        else:
            db = build_gt_database(
                NuScenesDetection(dcfg["records"]), DETECTION_CLASSES,
                min_points=dict(scfg.get("min_points", {})) or 5)
        sampler_obj = DataBaseSampler(
            db, {str(k): int(v) for k, v in dict(scfg.get(
                "max_per_class", {"car": 2})).items()},
            {c: i + 1 for i, c in enumerate(DETECTION_CLASSES)})
    ds = NuScenesDetection(
        dcfg["records"], max_points=int(dcfg.get("max_points", 120000)),
        max_gt=int(dcfg.get("max_gt", 500)),
        cbgs=bool(dcfg.get("cbgs", True)),
        augment=bool(dcfg.get("augment", True)), gt_sampler=sampler_obj,
        seed=seed)
    shard_id, num_shards = process_shard()
    sampler = DistributedSampler(len(ds), num_shards=num_shards,
                                 shard_id=shard_id, seed=seed)
    loader = DataLoader(ds, batch_size, sampler=sampler,
                        num_workers=dcfg.get("workers", 4))
    for step, raw in enumerate(loader):
        raw.pop("gt_attrs", None)
        for k in TRACKING_KEYS:
            raw.pop(k, None)
        raw["step"] = np.asarray(step, np.int32)
        yield raw


# nuScenes-like keyframes: a 32-beam lidar 1.84 m over the road on a car
# that drives through each scene, ten sweeps merged into each keyframe
NUSC_POINTS = (200000, 280000)  # merged points per keyframe, drawn in range
NUSC_KEYFRAME_S = 0.5    # keyframes 2 Hz
NUSC_SWEEP_S = 0.05      # sweeps 20 Hz: ten a keyframe, time lags 0-0.45 s
NUSC_LIDAR_Z = 1.84      # the lidar's height over the road
NUSC_RANGE = 60.0        # annotated objects lie within this of the lidar
NUSC_OBJECTS_IN_VIEW = 40  # objects around the car at a time, on average
NUSC_T0 = 1.5e9          # the first scene's start, seconds
# per class: share of the objects, mean (w, l, h) in m (jittered ~8 %),
# top speed in m/s and share of them parked or standing
NUSC_OBJECT_CLASSES = {
    "car": (0.36, (1.95, 4.62, 1.73), 12.0, 0.5),
    "truck": (0.07, (2.51, 6.93, 2.84), 10.0, 0.5),
    "construction_vehicle": (0.03, (2.85, 6.37, 3.19), 2.0, 0.7),
    "bus": (0.03, (2.94, 10.5, 3.47), 10.0, 0.4),
    "trailer": (0.03, (2.90, 12.29, 3.87), 8.0, 0.6),
    "barrier": (0.12, (2.53, 0.50, 0.98), 0.0, 1.0),
    "motorcycle": (0.04, (0.77, 2.11, 1.47), 10.0, 0.5),
    "bicycle": (0.04, (0.60, 1.70, 1.28), 5.0, 0.5),
    "pedestrian": (0.20, (0.67, 0.73, 1.77), 1.5, 0.3),
    "traffic_cone": (0.08, (0.41, 0.41, 1.07), 0.0, 1.0),
}


def _nusc_scene_objects(rs: np.random.RandomState, ego_xy: np.ndarray,
                        ego_yaw: np.ndarray, first_id: int):
    """A scene's objects in the global frame: each spawned near the car at
    a random keyframe, apart from the others in BEV there; (n, 10) rows of
    [x0, y0, z_ground, w, l, h, vx, vy, yaw, class id] (the position at
    the scene's start, the velocity constant), and their track ids."""
    names = list(NUSC_OBJECT_CLASSES)
    share = np.array([NUSC_OBJECT_CLASSES[c][0] for c in names])
    k = len(ego_xy)
    n = int(NUSC_OBJECTS_IN_VIEW * (1 + 0.1 * (k - 1)))
    rows = []
    for _ in range(n):
        ci = rs.choice(len(names), p=share / share.sum())
        _, size, top, parked = NUSC_OBJECT_CLASSES[names[ci]]
        w, l, h = np.asarray(size) * np.exp(0.08 * rs.randn(3))
        speed = 0.0 if rs.rand() < parked else rs.uniform(0.3, 1.0) * top
        at = rs.randint(k)
        for _ in range(20):
            r = NUSC_RANGE * np.sqrt(rs.uniform(0.01, 1.0))
            a = rs.uniform(-np.pi, np.pi)
            xy = ego_xy[at] + r * np.array([np.cos(a), np.sin(a)])
            yaw = rs.uniform(-np.pi, np.pi)
            v = speed * np.array([np.cos(yaw), np.sin(yaw)])
            xy0 = xy - v * at * NUSC_KEYFRAME_S
            clear = all(np.hypot(*(xy0 + v * at * NUSC_KEYFRAME_S
                                   - (o[:2] + o[6:8] * at * NUSC_KEYFRAME_S)))
                        > (l + o[4]) / 2 for o in rows)
            if clear:
                rows.append(np.array([xy0[0], xy0[1], 0.0, w, l, h, v[0],
                                      v[1], yaw, ci + 1]))
                break
    rows = np.stack(rows) if rows else np.zeros((0, 10))
    return rows, first_id + np.arange(len(rows), dtype=np.int32)


def _nusc_points(rs: np.random.RandomState, boxes: np.ndarray, total: int
                 ) -> np.ndarray:
    """A merged cloud (total, 5) [x, y, z, intensity, time lag] around
    lidar-frame ``boxes`` (G, 9): points inside each box, fewer the
    farther, each at the box's place at its sweep's time (the box moved
    back by its velocity times the lag), then road and clutter out to 70 m
    (some outside any configuration's range)."""
    parts = []
    for b in boxes:
        k = int(np.clip(6000.0 / max(np.hypot(b[0], b[1]), 1.0), 5, 600))
        u = rs.uniform(-0.5, 0.5, (k, 3))
        lag = NUSC_SWEEP_S * rs.randint(0, 10, k)
        c, s = np.cos(b[8]), np.sin(b[8])
        dx, dy = u[:, 0] * b[3], u[:, 1] * b[4]  # w along the yaw's axis
        parts.append(np.stack([b[0] - b[6] * lag + c * dx - s * dy,
                               b[1] - b[7] * lag + s * dx + c * dy,
                               b[2] + u[:, 2] * b[5], rs.rand(k), lag], -1))
    rest = total - sum(len(p) for p in parts)
    clutter = rest // 5
    ground = rest - clutter
    r = 70.0 * rs.uniform(0, 1, rest) ** 1.5
    a = rs.uniform(-np.pi, np.pi, rest)
    z = np.concatenate([-NUSC_LIDAR_Z + 0.05 * rs.randn(ground),
                        rs.uniform(-NUSC_LIDAR_Z, 2.0, clutter)])
    parts.append(np.stack([r * np.cos(a), r * np.sin(a), z, rs.rand(rest),
                           NUSC_SWEEP_S * rs.randint(0, 10, rest)], -1))
    points = np.concatenate(parts).astype(np.float32)
    return points[rs.permutation(len(points))]


def synthetic_nuscenes_records(num_frames: int, seed: int = 0,
                               scenes: int = 1
                               ) -> List[Dict[str, np.ndarray]]:
    """nuScenes-like keyframes in memory, from numpy ``RandomState(seed)``,
    in the layout of ``data/nuscenes.py:nuscenes_examples``: ``num_frames``
    keyframes split over ``scenes`` scenes in order (the first scenes take
    the remainder), NUSC_KEYFRAME_S apart within a scene. In each scene a
    car drives at 0-10 m/s along a gently turning path from a random place
    and heading; objects of all ten DETECTION_CLASSES
    (``NUSC_OBJECT_CLASSES``: shares, sizes, speeds) move at constant
    velocity along their heading, so each keeps its track id from keyframe
    to keyframe. Per keyframe: the objects within NUSC_RANGE of the lidar
    as lidar-frame boxes [x, y, z_centre, w, l, h, vx, vy, yaw] (9-wide
    f32), gt_classes (1-based), gt_attrs (``infer_attributes`` of their
    velocity), the token, and the tracking keys (scene, timestamp in s,
    global_from_lidar, gt_track_ids); the merged cloud of NUSC_POINTS
    points of 5 features (``_nusc_points``)."""
    rs = np.random.RandomState(seed)
    sizes = [num_frames // scenes + (i < num_frames % scenes)
             for i in range(scenes)]
    records, next_id = [], 0
    for si, k in enumerate(sizes):
        if k == 0:
            continue
        speed, turn = rs.uniform(0, 10), rs.uniform(-0.05, 0.05)
        yaw0 = rs.uniform(-np.pi, np.pi)
        ego_yaw = yaw0 + turn * NUSC_KEYFRAME_S * np.arange(k)
        step = speed * NUSC_KEYFRAME_S * np.stack([np.cos(ego_yaw),
                                                   np.sin(ego_yaw)], -1)
        ego_xy = rs.uniform(-1000, 1000, 2) + np.concatenate(
            [np.zeros((1, 2)), np.cumsum(step[:-1], 0)])
        objs, ids = _nusc_scene_objects(rs, ego_xy, ego_yaw, next_id)
        next_id += len(objs)
        scene = np.frombuffer(f"scene-{seed:04d}-{si:04d}".encode().ljust(
            32)[:32], np.uint8).copy()
        for f in range(k):
            t = f * NUSC_KEYFRAME_S
            c, s = np.cos(ego_yaw[f]), np.sin(ego_yaw[f])
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            T = np.eye(4)
            T[:3, :3] = rot
            T[:3, 3] = [ego_xy[f, 0], ego_xy[f, 1], NUSC_LIDAR_Z]
            rel = objs[:, :2] + objs[:, 6:8] * t - ego_xy[f]
            xy = rel @ rot[:2, :2]
            keep = np.hypot(xy[:, 0], xy[:, 1]) < NUSC_RANGE
            o = objs[keep]
            boxes = np.concatenate([
                xy[keep], (o[:, 5:6] / 2 - NUSC_LIDAR_Z), o[:, 3:6],
                o[:, 6:8] @ rot[:2, :2],
                (np.remainder(o[:, 8:9] - ego_yaw[f] + np.pi, 2 * np.pi)
                 - np.pi)], 1).astype(np.float32)
            classes = o[:, 9].astype(np.int32)
            total = rs.randint(*NUSC_POINTS)
            records.append({
                "points": _nusc_points(rs, boxes, total),
                "gt_boxes": boxes,
                "gt_classes": classes,
                "gt_attrs": infer_attributes(boxes, classes),
                "token": np.frombuffer(f"{seed:04d}-{si:04d}-{f:04d}".encode(
                ).ljust(32)[:32], np.uint8).copy(),
                "scene": scene,
                "timestamp": np.float64(NUSC_T0 + 1000.0 * si + t),
                "global_from_lidar": T.astype(np.float32),
                "gt_track_ids": ids[keep].astype(np.int32),
            })
    return records


def waymo_batches(cfg: Mapping, batch_size: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Waymo records -> raw host batches (points, points_mask, gt_boxes
    9-wide, gt_classes, gt_mask; ``step`` counting from 0), the reference's
    recipe: the GT database loaded from ``gt_sampler.database`` where that
    file exists, else built from the records' 7-wide boxes with the
    config's per-class ``min_points`` (default 5); ``DataBaseSampler``
    (``max_per_class``, default {VEHICLE: 15}); ``WaymoDetection``
    (``max_points`` 160000, ``max_gt`` 200, ``augment`` on, by default)
    seeded with ``seed``, this process's shard and ``cfg["data"]
    ["workers"]`` threads (default 4). The lidar point counts are left out
    of the batch (they feed the evaluation, not the loss). ``cfg`` is a
    configuration mapping as its YAML file loads, with ``data.records`` a
    shard pattern or records in memory."""
    dcfg = cfg["data"]
    sampler_obj = None
    scfg = dcfg.get("gt_sampler")
    if scfg:
        path = scfg.get("database")
        if path and os.path.exists(path):
            db = load_database(path)
        else:
            db = build_gt_database(
                WaymoDetection(dcfg["records"]), WAYMO_CLASSES,
                min_points=dict(scfg.get("min_points", {})) or 5)
        sampler_obj = DataBaseSampler(
            db, {str(k): int(v) for k, v in dict(scfg.get(
                "max_per_class", {"VEHICLE": 15})).items()},
            {c: i + 1 for i, c in enumerate(WAYMO_CLASSES)})
    ds = WaymoDetection(
        dcfg["records"], max_points=int(dcfg.get("max_points", 160000)),
        max_gt=int(dcfg.get("max_gt", 200)),
        augment=bool(dcfg.get("augment", True)), gt_sampler=sampler_obj,
        seed=seed)
    shard_id, num_shards = process_shard()
    sampler = DistributedSampler(len(ds), num_shards=num_shards,
                                 shard_id=shard_id, seed=seed)
    loader = DataLoader(ds, batch_size, sampler=sampler,
                        num_workers=dcfg.get("workers", 4))
    for step, raw in enumerate(loader):
        raw.pop("gt_num_points", None)
        raw["step"] = np.asarray(step, np.int32)
        yield raw


# Waymo-like frames: the top lidar, 64 beams from -17.6 to +2.4 degrees,
# 2.1 m over the road in the vehicle frame (z = 0 on the road), 75 m range.
# The field of view and the range are the top lidar's in Sun et al.,
# "Scalability in Perception for Autonomous Driving: Waymo Open Dataset",
# CVPR 2020, Table 1; the 64 beams are the rows of its range image. The
# mount height, the returns per object, the clutter share and the ground
# rings are this generator's own choices, not measured on real frames: the
# frames' density (the share of pillars kept, how full they are) is theirs.
WAYMO_POINTS = (160000, 180000)  # returns per frame, drawn in this range
WAYMO_BEAMS = 64
WAYMO_ELEVATION = (-17.6, 2.4)   # degrees
WAYMO_LIDAR_Z = 2.1
WAYMO_RANGE = 75.0
WAYMO_OBJECTS = (10, 60)     # labelled objects per frame, drawn in range
WAYMO_SPARSE_SHARE = 0.2     # objects with 0-5 returns (far or occluded)
# per class: share of the objects and mean (w, l, h) in m (jittered ~8 %)
WAYMO_OBJECT_CLASSES = {"VEHICLE": (0.6, (2.1, 4.8, 1.8)),
                        "PEDESTRIAN": (0.3, (0.85, 0.9, 1.75)),
                        "CYCLIST": (0.1, (0.8, 1.8, 1.75))}


def _waymo_objects(rs: np.random.RandomState, n: int) -> np.ndarray:
    """Up to ``n`` objects apart in BEV, within WAYMO_RANGE of the lidar:
    (k, 8) rows [x, y, z_bottom, w, l, h, yaw, class id 1-based]."""
    names = list(WAYMO_OBJECT_CLASSES)
    share = np.array([WAYMO_OBJECT_CLASSES[c][0] for c in names])
    rows = []
    for ci in rs.choice(len(names), n, p=share / share.sum()):
        w, l, h = np.asarray(WAYMO_OBJECT_CLASSES[names[ci]][1]) * np.exp(
            0.08 * rs.randn(3))
        for _ in range(20):
            r = (WAYMO_RANGE - 2.0) * np.sqrt(rs.uniform(0.01, 1.0))
            a = rs.uniform(-np.pi, np.pi)
            xy = r * np.array([np.cos(a), np.sin(a)])
            if all(np.hypot(*(xy - o[:2])) > (l + o[4]) / 2 + 0.3
                   for o in rows):
                rows.append(np.array([xy[0], xy[1], rs.uniform(0.0, 0.05), w,
                                      l, h, rs.uniform(-np.pi, np.pi),
                                      ci + 1]))
                break
    return np.stack(rows) if rows else np.zeros((0, 8))


def _waymo_points(rs: np.random.RandomState, objs: np.ndarray, total: int
                  ) -> np.ndarray:
    """A frame's returns (total, 5) [x, y, z, intensity, elongation]: points
    inside each object, fewer the farther and 0-5 for WAYMO_SPARSE_SHARE of
    them; the rest on the beams' rings on the road (below every box's
    bottom) where a beam meets it within WAYMO_RANGE, and a fifth on
    walls and trees 15-78 m out and 0-4 m high (a few past the
    configurations' range)."""
    parts = []
    for o in objs:
        r = np.hypot(o[0], o[1])
        if rs.rand() < WAYMO_SPARSE_SHARE:
            k = rs.randint(0, 6)
        else:
            k = int(np.clip(15000.0 / max(r, 3.0) * o[4] * o[5] / 8.6, 6,
                            3000))
        u = rs.uniform(-0.5, 0.5, (k, 3))
        c, s = np.cos(o[6]), np.sin(o[6])
        dx, dy = u[:, 0] * o[3], u[:, 1] * o[4]  # w along the yaw's axis
        parts.append(np.stack([o[0] + c * dx - s * dy, o[1] + s * dx + c * dy,
                               o[2] + (u[:, 2] + 0.5) * o[5], rs.rand(k),
                               rs.beta(1.0, 8.0, k)], -1))
    rest = total - sum(len(p) for p in parts)
    clutter = rest // 5
    ground = rest - clutter
    elev = np.deg2rad(np.linspace(*WAYMO_ELEVATION, WAYMO_BEAMS))
    reach = WAYMO_LIDAR_Z / np.tan(-elev[elev < 0])
    rings = reach[reach <= WAYMO_RANGE]
    r = np.concatenate([rings[rs.randint(0, len(rings), ground)]
                        * (1 + 0.01 * rs.randn(ground)),
                        rs.uniform(15.0, 78.0, clutter)])
    a = rs.uniform(-np.pi, np.pi, rest)
    z = np.concatenate([rs.uniform(-0.1, -0.01, ground),
                        rs.uniform(0.0, 4.0, clutter)])
    parts.append(np.stack([r * np.cos(a), r * np.sin(a), z,
                           rs.beta(0.5, 3.0, rest), rs.beta(1.0, 8.0, rest)],
                          -1))
    points = np.concatenate(parts).astype(np.float32)
    return points[rs.permutation(len(points))]


def synthetic_waymo_records(num_frames: int, seed: int = 0
                            ) -> List[Dict[str, np.ndarray]]:
    """Waymo-like frames in memory, from numpy ``RandomState(seed)``, in the
    layout of ``data/waymo.py:waymo_frame_to_example``: per frame
    WAYMO_OBJECTS vehicles, pedestrians and cyclists
    (``WAYMO_OBJECT_CLASSES``: shares and sizes) on the road, apart in BEV,
    any heading, and WAYMO_POINTS returns of 5 features
    (``_waymo_points``). Each box's lidar point count is the number of the
    frame's points inside it (BEV and height), so that the objects with 0-5
    returns are LEVEL_2 to the evaluator."""
    rs = np.random.RandomState(seed)
    records = []
    for _ in range(num_frames):
        objs = _waymo_objects(rs, rs.randint(WAYMO_OBJECTS[0],
                                             WAYMO_OBJECTS[1] + 1))
        points = _waymo_points(rs, objs, rs.randint(*WAYMO_POINTS))
        inside = host_ops.points_in_rboxes(
            points[:, :2], objs[:, [0, 1, 3, 4, 6]].astype(np.float32))
        z = points[:, 2:3]
        inside &= (z >= objs[None, :, 2]) & (z <= objs[None, :, 2]
                                              + objs[None, :, 5])
        labels = [{"center": (o[0], o[1], o[2] + o[5] / 2),
                   "size": (o[4], o[3], o[5]), "heading": o[6],
                   "type": int(o[7]), "num_points": int(k)}
                  for o, k in zip(objs, inside.sum(0))]
        records.append(waymo_frame_to_example(points, labels))
    return records
