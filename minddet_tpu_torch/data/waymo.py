"""Waymo Open Dataset data: Frame decoding, records and the host examples
(counterpart of ``minddet_tpu/data/waymo.py``: ``WAYMO_CLASSES``,
``waymo_frame_to_example``, ``decode_waymo_frame``,
``convert_waymo_tfrecords`` and ``WaymoDetection``).

Host numpy, as the reference's. Records hold the points as extracted
(N, 5) f32 [x, y, z, intensity, elongation], 7-wide z-bottom boxes [x, y,
z_bottom, w, l, h, yaw], 1-based classes into WAYMO_CLASSES and each box's
lidar point count. TensorFlow and the Waymo toolkit are needed only by the
offline conversion, and are imported inside it.

``WaymoDetection`` reads record shards or holds records in memory (what a
host without ``array_record`` feeds it). Its examples carry 9-wide z-centre
boxes with a zero velocity, the layout of CenterPoint's targets and of the
global augmentation (the head's velocity code weights still apply, as in
the reference). One ``np.random.RandomState`` per dataset draws the GT
sampler, the augmentation and the subsample, as in the reference; the
loader's threads share it, so past one worker the batches depend on the
thread schedule (a fault of the reference that the port keeps).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from minddet_tpu_torch.data.nuscenes import global_augment_3d
from minddet_tpu_torch.data.records import RecordDataset, write_records

WAYMO_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")


def waymo_frame_to_example(points: np.ndarray, labels: Sequence[Dict]
                           ) -> Dict[str, Any]:
    """A record from extracted points and label dicts ({center (3,), size
    (l, w, h), heading, type 1-based into WAYMO_CLASSES, num_points
    (default 100)}, the fields of a Waymo ``Label.Box``): points f32,
    gt_boxes (G, 7) f32 [x, y, z_bottom, w, l, h, yaw], gt_classes,
    num_points_in_gt."""
    boxes, classes, npts = [], [], []
    for lb in labels:
        cx, cy, cz = lb["center"]
        l, w, h = lb["size"]
        boxes.append([cx, cy, cz - h / 2.0, w, l, h, lb["heading"]])
        classes.append(int(lb["type"]))
        npts.append(int(lb.get("num_points", 100)))
    return {"points": np.asarray(points, np.float32),
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
            "gt_classes": np.asarray(classes, np.int32),
            "num_points_in_gt": np.asarray(npts, np.int32)}


# the proto's Label.Type {0 UNKNOWN, 1 VEHICLE, 2 PEDESTRIAN, 3 SIGN,
# 4 CYCLIST} -> 1-based WAYMO_CLASSES: SIGN and UNKNOWN are dropped
_TYPE_MAP = {1: 1, 2: 2, 4: 3}


def decode_waymo_frame(frame, frame_utils, max_points: int) -> Dict[str, Any]:
    """One parsed Frame proto -> a record (``waymo_frame_to_example``).
    ``frame_utils`` is the toolkit's module, or a double with its
    ``parse_range_image_and_camera_projection`` and
    ``convert_range_image_to_point_cloud``. The polar features come first
    ([range, intensity, elongation, x, y, z]) and are reordered to [x, y,
    z, intensity, elongation]; the first ``max_points`` points are kept."""
    ri, cp, _ = frame_utils.parse_range_image_and_camera_projection(frame)
    pts, _ = frame_utils.convert_range_image_to_point_cloud(
        frame, ri, cp, keep_polar_features=True)
    raw = np.concatenate(pts, axis=0)[:max_points]
    labels = [{"center": (lb.box.center_x, lb.box.center_y,
                          lb.box.center_z),
               "size": (lb.box.length, lb.box.width, lb.box.height),
               "heading": lb.box.heading, "type": _TYPE_MAP[lb.type],
               "num_points": lb.num_lidar_points_in_box}
              for lb in frame.laser_labels if lb.type in _TYPE_MAP]
    return waymo_frame_to_example(raw[:, [3, 4, 5, 1, 2]], labels)


def convert_waymo_tfrecords(tfrecord_paths: Sequence[str], out_prefix: str,
                            max_points: int = 180000,
                            _modules: Optional[Dict[str, Any]] = None
                            ) -> List[str]:
    """Waymo Frame TFRecords -> record shards under ``out_prefix`` (one
    record a frame, ``decode_waymo_frame``); returns the shards' paths.
    Needs tensorflow and ``waymo_open_dataset`` (ImportError without
    them); ``_modules`` gives {"tf", "dataset_pb2", "frame_utils"} doubles
    in their place."""
    if _modules is None:
        try:
            import tensorflow as tf
            from waymo_open_dataset import dataset_pb2
            from waymo_open_dataset.utils import frame_utils
        except ImportError as e:
            raise ImportError(
                "convert_waymo_tfrecords needs tensorflow and "
                "waymo_open_dataset (conversion only); install them on the "
                "machine that converts") from e
    else:
        tf = _modules["tf"]
        dataset_pb2 = _modules["dataset_pb2"]
        frame_utils = _modules["frame_utils"]

    def examples() -> Iterator[Dict[str, Any]]:
        for path in tfrecord_paths:
            for data in tf.data.TFRecordDataset(path, compression_type=""):
                frame = dataset_pb2.Frame()
                frame.ParseFromString(bytes(data.numpy()))
                yield decode_waymo_frame(frame, frame_utils, max_points)

    return write_records(out_prefix, examples())


class WaymoDetection:
    """Waymo records as fixed-shape host examples: points (max_points, F)
    zero-padded (a random subsample where the cloud has more),
    points_mask, gt_boxes (max_gt, 9) [x, y, z_centre, w, l, h, 0, 0, yaw],
    gt_classes (1-based into WAYMO_CLASSES), gt_mask, and where the
    records carry lidar point counts ``gt_num_points`` (100 in slots of
    pasted or padded boxes).

    ``records``: a shard pattern or a list of shard paths (read through
    ``RecordDataset``), a record dataset, or a sequence of record dicts in
    memory. With ``gt_sampler`` and ``augment`` set, ``__getitem__`` runs
    the reference's training recipe in order: paste database objects (its
    database holds the records' 7-wide boxes), turn the boxes to 9-wide
    z-centre ones, then the global flip / rotate / scale / translate
    (``global_augment_3d``); all draws from one ``RandomState(seed)``."""

    def __init__(self, records, max_points: int = 160000, max_gt: int = 200,
                 augment: bool = False, gt_sampler=None, seed: int = 0):
        if isinstance(records, str) or (
                isinstance(records, (list, tuple)) and records
                and isinstance(records[0], str)):
            records = RecordDataset(records)
        self.records = records
        self.max_points = max_points
        self.max_gt = max_gt
        self.augment = augment
        self.gt_sampler = gt_sampler
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        points = np.asarray(rec["points"], np.float32)
        boxes7 = np.asarray(rec["gt_boxes"], np.float32).reshape(-1, 7)
        classes = np.asarray(rec["gt_classes"], np.int32)
        if self.gt_sampler is not None:
            points, boxes7, classes = self.gt_sampler.sample(
                self._rng, points, boxes7, classes)
        if len(boxes7):
            boxes = np.concatenate(
                [boxes7[:, :2], (boxes7[:, 2] + boxes7[:, 5] / 2)[:, None],
                 boxes7[:, 3:6], np.zeros((len(boxes7), 2), np.float32),
                 boxes7[:, 6:7]], axis=1)
        else:
            boxes = np.zeros((0, 9), np.float32)
        if self.augment:
            points, boxes = global_augment_3d(self._rng, points, boxes)

        n = min(len(points), self.max_points)
        p = np.zeros((self.max_points, points.shape[-1]), np.float32)
        sel = self._rng.permutation(len(points))[:n] \
            if len(points) > n else slice(0, n)
        p[:n] = points[sel]
        g = min(len(boxes), self.max_gt)
        gb = np.zeros((self.max_gt, 9), np.float32)
        gc = np.zeros((self.max_gt,), np.int32)
        gm = np.zeros((self.max_gt,), bool)
        gb[:g] = boxes[:g]
        gc[:g] = classes[:g]
        gm[:g] = True
        out = {"points": p, "points_mask": np.arange(self.max_points) < n,
               "gt_boxes": gb, "gt_classes": gc, "gt_mask": gm}
        if "num_points_in_gt" in rec:
            npts = np.full((self.max_gt,), 100, np.int32)
            src = np.asarray(rec["num_points_in_gt"], np.int32)
            k = min(g, len(src))  # pasted objects keep the default
            npts[:k] = src[:k]
            out["gt_num_points"] = npts
        return out
