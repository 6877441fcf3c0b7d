"""KITTI data: label and calib parsing, frame conversions, records, the
training augmentations and the host examples (counterpart of
``minddet_tpu/data/kitti.py``: ``parse_label_file``, ``parse_calib_file``,
``camera_to_lidar_boxes``, ``read_velodyne``, ``lidar_box_to_camera``,
``camera_box_corners``, ``project_camera_to_image``,
``detections_to_kitti_annos``, ``kitti_examples``, ``create_kitti_records``,
``noise_per_object``, ``KittiDetection`` and ``global_augment``).

Host numpy, as the reference's: records stay raw (points, lidar boxes and
the camera-frame labels); voxelization and target assignment run on the
device in the train step. ``KittiDetection`` reads record shards or holds
records in memory (what a host without ``array_record`` feeds it);
``kitti_examples`` imports ``cv2`` only where a frame has an image. The
per-object noise and the GT-database sampler test collisions with the
port's host ops (``ops/host_ops.py``), the reference's C++.

One ``np.random.RandomState`` per dataset draws the sampler, the noise, the
global augmentation and the subsample, as in the reference; the loader's
threads share it, so past one worker the batches depend on the thread
schedule (a fault of the reference that the port keeps).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from minddet_tpu_torch.data.records import RecordDataset, write_records
from minddet_tpu_torch.ops import host_ops

KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist", "Van", "Truck",
                 "Person_sitting", "Tram", "Misc")


def parse_label_file(path: str) -> List[Dict[str, Any]]:
    """KITTI label txt -> list of object dicts (camera-frame boxes;
    dimensions stored l, h, w). DontCare rows are kept; rows of fewer than
    15 fields are dropped."""
    objs = []
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if len(p) < 15:
                continue
            objs.append({
                "name": p[0],
                "truncated": float(p[1]),
                "occluded": int(p[2]),
                "alpha": float(p[3]),
                "bbox": np.array([float(x) for x in p[4:8]], np.float32),
                "dimensions": np.array(
                    [float(p[10]), float(p[8]), float(p[9])], np.float32),
                "location": np.array([float(x) for x in p[11:14]],
                                     np.float32),
                "rotation_y": float(p[14]),
            })
    return objs


def parse_calib_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI calib txt -> P2 (3, 4), and R0_rect and Tr_velo_to_cam as
    (4, 4) homogeneous matrices."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = np.array([float(x) for x in v.split()],
                                      np.float32)
    calib = {}
    if "P2" in out:
        calib["P2"] = out["P2"].reshape(3, 4)
    if "R0_rect" in out:
        r = np.eye(4, dtype=np.float32)
        r[:3, :3] = out["R0_rect"].reshape(3, 3)
        calib["R0_rect"] = r
    if "Tr_velo_to_cam" in out:
        t = np.eye(4, dtype=np.float32)
        t[:3, :4] = out["Tr_velo_to_cam"].reshape(3, 4)
        calib["Tr_velo_to_cam"] = t
    return calib


def camera_to_lidar_boxes(objs: List[Dict], calib: Dict[str, np.ndarray]
                          ) -> np.ndarray:
    """Camera-frame objects -> (N, 7) lidar boxes [x, y, z, w, l, h, yaw]:
    z the box bottom, yaw = -ry - pi / 2."""
    if not objs:
        return np.zeros((0, 7), np.float32)
    loc = np.stack([o["location"] for o in objs])
    dims = np.stack([o["dimensions"] for o in objs])
    ry = np.array([o["rotation_y"] for o in objs], np.float32)
    tr = calib["R0_rect"] @ calib["Tr_velo_to_cam"]
    inv = np.linalg.inv(tr)
    pts = np.concatenate([loc, np.ones((len(loc), 1), np.float32)], -1)
    lidar_xyz = (pts @ inv.T)[:, :3]
    l, h, w = dims[:, 0], dims[:, 1], dims[:, 2]
    yaw = -ry - np.pi / 2
    return np.stack([lidar_xyz[:, 0], lidar_xyz[:, 1], lidar_xyz[:, 2], w, l,
                     h, yaw], -1).astype(np.float32)


def read_velodyne(path: str) -> np.ndarray:
    return np.fromfile(path, np.float32).reshape(-1, 4)


def lidar_box_to_camera(boxes7: np.ndarray, trv2c_rect: np.ndarray
                        ) -> np.ndarray:
    """(N, 7) lidar [x, y, z_bottom, w, l, h, yaw] -> camera [x, y, z, l, h,
    w, ry], ry = -yaw - pi / 2 (``camera_to_lidar_boxes``'s inverse)."""
    n = len(boxes7)
    if n == 0:
        return np.zeros((0, 7), np.float32)
    xyz1 = np.concatenate([boxes7[:, :3], np.ones((n, 1), np.float32)], -1)
    cam = (xyz1 @ trv2c_rect.T)[:, :3]
    dims = boxes7[:, [4, 5, 3]]
    ry = -boxes7[:, 6] - np.pi / 2
    return np.concatenate([cam, dims, ry[:, None]], -1).astype(np.float32)


def camera_box_corners(cam_boxes: np.ndarray) -> np.ndarray:
    """(N, 7) camera [x, y, z, l, h, w, ry] -> (N, 8, 3) corners: the
    location is the bottom face's centre, the box spans y in [-h, 0]
    (camera y down), rotated about the camera y axis."""
    l, h, w = cam_boxes[:, 3], cam_boxes[:, 4], cam_boxes[:, 5]
    x = np.stack([l / 2, l / 2, -l / 2, -l / 2] * 2, -1)
    z = np.stack([w / 2, -w / 2, -w / 2, w / 2] * 2, -1)
    y = np.stack([np.zeros_like(h)] * 4 + [-h] * 4, -1)
    ry = cam_boxes[:, 6]
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    xr = c * x + s * z
    zr = -s * x + c * z
    return np.stack([xr, y, zr], -1) + cam_boxes[:, None, :3]


def project_camera_to_image(pts: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """(..., 3) camera points -> (..., 2) pixels through P2."""
    hom = pts @ p2[:, :3].T + p2[:, 3]
    return hom[..., :2] / np.maximum(hom[..., 2:3], 1e-6)


def detections_to_kitti_annos(boxes7: np.ndarray, scores: np.ndarray,
                              labels: np.ndarray, classes: Sequence[str],
                              trv2c_rect: np.ndarray, p2: np.ndarray,
                              img_shape: Sequence[int]
                              ) -> Dict[str, np.ndarray]:
    """Lidar detections -> a KITTI anno: camera boxes, the projected image
    bbox clipped to the frame, alpha, scores (occluded and truncated 0).
    Detections with a camera z at most 0.1 or a projected bbox wholly
    outside the image are dropped; a label outside ``classes`` is named
    Car."""
    cam = lidar_box_to_camera(boxes7, trv2c_rect)
    ih, iw = int(img_shape[0]), int(img_shape[1])
    keep = cam[:, 2] > 0.1
    cam, boxes7 = cam[keep], boxes7[keep]
    scores, labels = np.asarray(scores)[keep], np.asarray(labels)[keep]
    uv = project_camera_to_image(camera_box_corners(cam), p2)
    bbox = np.concatenate([uv.min(1), uv.max(1)], -1) if len(uv) \
        else np.zeros((0, 4))
    inside = np.ones(len(cam), bool)
    if len(cam):
        inside = ~((bbox[:, 0] > iw) | (bbox[:, 1] > ih) | (bbox[:, 2] < 0)
                   | (bbox[:, 3] < 0))
    cam, boxes7, bbox = cam[inside], boxes7[inside], bbox[inside]
    scores, labels = scores[inside], labels[inside]
    bbox[:, 0::2] = np.clip(bbox[:, 0::2], 0, iw)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2], 0, ih)
    alpha = -np.arctan2(-boxes7[:, 1], boxes7[:, 0]) + cam[:, 6]
    name = np.asarray([classes[int(c)] if 0 <= c < len(classes) else "Car"
                       for c in labels])
    return {
        "name": name,
        "bbox": bbox.astype(np.float32),
        "location": cam[:, :3].astype(np.float32),
        "dimensions": cam[:, 3:6].astype(np.float32),
        "rotation_y": cam[:, 6].astype(np.float32),
        "alpha": alpha.astype(np.float32),
        "occluded": np.zeros(len(cam), np.int64),
        "truncated": np.zeros(len(cam), np.float32),
        "score": scores.astype(np.float32),
    }


def _stack(values, width: int) -> np.ndarray:
    return (np.stack(values).astype(np.float32) if values
            else np.zeros((0, width), np.float32))


def kitti_examples(root: str, split_ids: Sequence[str],
                   classes: Sequence[str] = ("Car",),
                   training_dir: str = "training"
                   ) -> Iterator[Dict[str, Any]]:
    """Yield record dicts from KITTI's raw files: points, the lidar boxes
    and 1-based classes of the objects of ``classes``, frame_id, P2,
    Trv2c_rect, img_shape (the image's where it can be read, else 375 x
    1242) and every label row (DontCare included) under ``anno_*``."""
    name_to_id = {c: i + 1 for i, c in enumerate(classes)}
    for sid in split_ids:
        base = os.path.join(root, training_dir)
        label = parse_label_file(os.path.join(base, "label_2", f"{sid}.txt"))
        calib = parse_calib_file(os.path.join(base, "calib", f"{sid}.txt"))
        points = read_velodyne(os.path.join(base, "velodyne", f"{sid}.bin"))
        objs = [o for o in label if o["name"] in name_to_id]
        boxes = camera_to_lidar_boxes(objs, calib)
        trv2c_rect = (calib["R0_rect"] @ calib["Tr_velo_to_cam"]
                      if "R0_rect" in calib and "Tr_velo_to_cam" in calib
                      else np.eye(4, dtype=np.float32))
        img_shape = np.asarray([375, 1242], np.int32)
        img_path = os.path.join(base, "image_2", f"{sid}.png")
        if os.path.exists(img_path):
            try:
                import cv2

                img = cv2.imread(img_path)
                if img is not None:
                    img_shape = np.asarray(img.shape[:2], np.int32)
            except ImportError:
                pass
        yield {
            "points": points,
            "gt_boxes": boxes,
            "gt_classes": np.array([name_to_id[o["name"]] for o in objs],
                                   np.int32),
            "frame_id": np.frombuffer(sid.encode().ljust(16), np.uint8).copy(),
            "P2": calib.get("P2", np.zeros((3, 4), np.float32)),
            "Trv2c_rect": trv2c_rect.astype(np.float32),
            "img_shape": img_shape,
            "anno_name": np.array([o["name"] for o in label], dtype="U16"),
            "anno_bbox": _stack([o["bbox"] for o in label], 4),
            "anno_alpha": np.array([o["alpha"] for o in label], np.float32),
            "anno_occluded": np.array([o["occluded"] for o in label],
                                      np.int64),
            "anno_truncated": np.array([o["truncated"] for o in label],
                                       np.float32),
            "anno_location": _stack([o["location"] for o in label], 3),
            "anno_dimensions": _stack([o["dimensions"] for o in label], 3),
            "anno_rotation_y": np.array([o["rotation_y"] for o in label],
                                        np.float32),
        }


def create_kitti_records(root: str, split_file: str, out_prefix: str,
                         classes: Sequence[str] = ("Car",)) -> List[str]:
    """The split's ``kitti_examples`` written to record shards."""
    with open(split_file) as f:
        ids = [line.strip() for line in f if line.strip()]
    return write_records(out_prefix, kitti_examples(root, ids, classes))


def noise_per_object(rng: np.random.RandomState, boxes: np.ndarray,
                     points: np.ndarray,
                     valid_mask: Optional[np.ndarray] = None,
                     rotation_perturb=(-np.pi / 20, np.pi / 20),
                     center_noise_std=(0.25, 0.25, 0.25), num_try: int = 100
                     ) -> tuple:
    """Per-object pose noise with collision rejection: for each valid box,
    ``num_try`` candidate (rotation about the box centre, translation)
    draws; the first whose BEV footprint touches no other box (earlier
    boxes at their noised pose) is applied to the box and to the points
    inside its original footprint and height (a point in several boxes
    moves with the first). Returns (points, boxes) copies."""
    boxes = np.array(boxes, np.float32, copy=True)
    points = np.array(points, np.float32, copy=True)
    n = len(boxes)
    if n == 0 or len(points) == 0:
        return points, boxes
    if valid_mask is None:
        valid_mask = np.ones(n, bool)
    loc_noises = rng.normal(scale=center_noise_std,
                            size=(n, num_try, 3)).astype(np.float32)
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=(n, num_try)).astype(np.float32)

    bev = boxes[:, [0, 1, 3, 4, 6]].copy()
    sel_loc = np.zeros((n, 3), np.float32)
    sel_rot = np.zeros((n,), np.float32)
    applied = np.zeros(n, bool)
    for i in range(n):
        if not valid_mask[i]:
            continue
        cand = np.tile(bev[i], (num_try, 1))
        cand[:, :2] += loc_noises[i, :, :2]
        cand[:, 4] += rot_noises[i]
        iou = host_ops.rotated_iou_matrix(cand, bev)
        iou[:, i] = 0.0
        ok = iou.max(axis=1) <= 0.0
        j = int(np.argmax(ok))
        if not ok[j]:
            continue
        sel_loc[i], sel_rot[i] = loc_noises[i, j], rot_noises[i, j]
        applied[i] = True
        bev[i] = cand[j]

    if not applied.any():
        return points, boxes
    orig_bev = boxes[:, [0, 1, 3, 4, 6]]
    inside = host_ops.points_in_rboxes(points[:, :2], orig_bev)
    zok = (points[:, 2:3] >= boxes[None, :, 2]) & (
        points[:, 2:3] <= boxes[None, :, 2] + boxes[None, :, 5])
    inside = inside & zok & applied[None, :]
    has_owner = inside.any(axis=1)
    owner = np.argmax(inside, axis=1)
    for i in np.nonzero(applied)[0]:
        pm = has_owner & (owner == i)
        if not pm.any():
            continue
        c, s = np.cos(sel_rot[i]), np.sin(sel_rot[i])
        rel = points[pm, :2] - boxes[i, :2]
        points[pm, 0] = c * rel[:, 0] - s * rel[:, 1] + boxes[i, 0]
        points[pm, 1] = s * rel[:, 0] + c * rel[:, 1] + boxes[i, 1]
        points[pm, :3] += sel_loc[i]
    boxes[applied, :3] += sel_loc[applied]
    boxes[applied, 6] += sel_rot[applied]
    return points, boxes


RAW_KEYS = ("P2", "Trv2c_rect", "img_shape", "frame_id")
ANNO_KEYS = ("name", "bbox", "alpha", "occluded", "truncated", "location",
             "dimensions", "rotation_y")


def kitti_gt_anno(record: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The evaluator's GT anno of a record, or of an example kept raw: its
    camera-frame labels (``anno_*``, DontCare rows included) without the
    prefix."""
    return {k: np.asarray(record[f"anno_{k}"]) for k in ANNO_KEYS}


class KittiDetection:
    """KITTI records as fixed-shape host examples: points (max_points, F)
    zero-padded (a random subsample where the cloud has more), points_mask,
    gt_boxes (max_gt, 7), gt_classes, gt_mask; with ``keep_raw`` also the
    calibration and the camera-frame labels (``anno_*``, ``RAW_KEYS``).

    ``records``: a shard pattern or a list of shard paths (read through
    ``RecordDataset``), a record dataset, or a sequence of record dicts in
    memory. With ``gt_sampler``, ``object_noise`` and ``augment`` set,
    ``__getitem__`` runs the reference's training recipe in order: paste
    database objects, per-object noise, global flip / rotate / scale /
    translate; all draws from one ``RandomState(seed)``."""

    def __init__(self, records, max_points: int = 20000, max_gt: int = 40,
                 gt_sampler=None, augment: bool = False,
                 object_noise: Optional[Dict[str, Any]] = None,
                 keep_raw: bool = False, seed: int = 0):
        if isinstance(records, str) or (
                isinstance(records, (list, tuple)) and records
                and isinstance(records[0], str)):
            records = RecordDataset(records)
        self.records = records
        self.max_points = max_points
        self.max_gt = max_gt
        self.gt_sampler = gt_sampler
        self.augment = augment
        self.object_noise = object_noise
        self.keep_raw = keep_raw
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        points = rec["points"]
        boxes = rec["gt_boxes"]
        classes = rec["gt_classes"]
        if self.gt_sampler is not None:
            points, boxes, classes = self.gt_sampler.sample(
                self._rng, points, boxes, classes)
        if self.object_noise is not None:
            points, boxes = noise_per_object(self._rng, boxes, points,
                                             **self.object_noise)
        if self.augment:
            points, boxes = global_augment(self._rng, points, boxes)

        n = min(len(points), self.max_points)
        p = np.zeros((self.max_points, points.shape[-1]), np.float32)
        sel = self._rng.permutation(len(points))[:n] \
            if len(points) > n else slice(0, n)
        p[:n] = points[sel]
        g = min(len(boxes), self.max_gt)
        gb = np.zeros((self.max_gt, 7), np.float32)
        gc = np.zeros((self.max_gt,), np.int32)
        gm = np.zeros((self.max_gt,), bool)
        gb[:g] = boxes[:g]
        gc[:g] = classes[:g]
        gm[:g] = True
        out = {"points": p, "points_mask": np.arange(self.max_points) < n,
               "gt_boxes": gb, "gt_classes": gc, "gt_mask": gm}
        if self.keep_raw:
            for k, v in rec.items():
                if k.startswith("anno_") or k in RAW_KEYS:
                    out[k] = v
        return out


def global_augment(rng: np.random.RandomState, points: np.ndarray,
                   boxes: np.ndarray, rot_range=(-np.pi / 4, np.pi / 4),
                   scale_range=(0.95, 1.05), flip_prob: float = 0.5,
                   translate_std=(0.2, 0.2, 0.2)) -> tuple:
    """Global flip over the x axis (with ``flip_prob``), rotation about z,
    scale and translation of the scene and its boxes, drawn in that
    order."""
    points = points.copy()
    boxes = boxes.copy() if len(boxes) else boxes
    if rng.rand() < flip_prob:
        points[:, 1] = -points[:, 1]
        if len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
    ang = rng.uniform(*rot_range)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]], np.float32)
    points[:, :2] = points[:, :2] @ rot.T
    if len(boxes):
        boxes[:, :2] = boxes[:, :2] @ rot.T
        boxes[:, 6] += ang
    sc = rng.uniform(*scale_range)
    points[:, :3] *= sc
    if len(boxes):
        boxes[:, :6] *= sc
    t = rng.normal(scale=translate_std, size=3).astype(np.float32)
    points[:, :3] += t
    if len(boxes):
        boxes[:, :3] += t
    return points, boxes
