"""GT-AUG database sampling: paste ground-truth objects into training scenes
(counterpart of ``minddet_tpu/data/gt_sampler.py``: ``_bev``,
``build_gt_database``, ``save_database``, ``load_database`` and
``DataBaseSampler``).

Host numpy, as the reference keeps it (a stateful database and rejection
sampling). The collision tests run through the port's host ops
(``ops/host_ops.py``: ``points_in_rboxes``, ``rotated_iou_matrix``), the
same C++ as the reference's, so both accept and reject the same
candidates.

The database maps a class name to a list of {points (N, F) relative to the
box origin, box (D,)}; D is 7 for KITTI [x, y, z_bottom, w, l, h, yaw] or 9
for nuScenes [x, y, z_center, w, l, h, vx, vy, yaw]: yaw is always the last
column.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np

from minddet_tpu_torch.ops import host_ops


def _bev(boxes: np.ndarray) -> np.ndarray:
    """(G, D >= 7) lidar boxes -> (G, 5) BEV [x, y, w, l, yaw = last]."""
    return boxes[:, [0, 1, 3, 4, boxes.shape[-1] - 1]]


def build_gt_database(dataset, class_names: Sequence[str],
                      min_points: Union[int, Mapping[str, int]] = 5
                      ) -> Dict[str, List[Dict]]:
    """Crop each ground-truth object's points from the records of
    ``dataset`` (its ``records`` where it has them, else its items): the
    points inside the box (BEV and height; z the bottom for 7-wide boxes,
    the centre for 9-wide ones), relative to the box origin, for objects
    of ``class_names`` (1-based ids in that order) with at least
    ``min_points`` of them (a number, or one per class name, default 5)."""
    db: Dict[str, List[Dict]] = {c: [] for c in class_names}
    id_to_name = {i + 1: c for i, c in enumerate(class_names)}
    for idx in range(len(dataset)):
        rec = dataset.records[idx] if hasattr(dataset, "records") \
            else dataset[idx]
        points = rec["points"]
        boxes = rec["gt_boxes"]
        classes = rec["gt_classes"]
        if len(boxes) == 0:
            continue
        z_center = boxes.shape[-1] == 9
        inside = host_ops.points_in_rboxes(points[:, :2], _bev(boxes))
        z_lo = boxes[None, :, 2] - (boxes[None, :, 5] / 2 if z_center else 0)
        zok = (points[:, 2:3] >= z_lo) & (
            points[:, 2:3] <= z_lo + boxes[None, :, 5])
        inside = inside & zok
        for g in range(len(boxes)):
            name = id_to_name.get(int(classes[g]))
            if name is None:
                continue
            obj_pts = points[inside[:, g]].copy()
            need = (min_points.get(name, 5)
                    if isinstance(min_points, Mapping) else min_points)
            if len(obj_pts) < need:
                continue
            obj_pts[:, :3] -= boxes[g, :3]
            db[name].append({"points": obj_pts.astype(np.float32),
                             "box": boxes[g].astype(np.float32)})
    return db


def save_database(db, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(db, f)


def load_database(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


class DataBaseSampler:
    """Paste sampled ground-truth objects into a scene, rejecting BEV
    collisions: per class of ``max_per_class`` (in its order), its count
    less the instances present, drawn twice over from the pool
    (``rng.randint``) and taken in turn while wanted; a candidate whose BEV
    IoU with an existing or accepted box exceeds 1e-3 is dropped. The
    scene's points inside accepted boxes are removed and the objects'
    points appended."""

    def __init__(self, database: Dict[str, List[Dict]],
                 max_per_class: Dict[str, int], class_ids: Dict[str, int]):
        self.db = {k: v for k, v in database.items() if v}
        self.max_per_class = max_per_class
        self.class_ids = class_ids

    def sample(self, rng: np.random.RandomState, points: np.ndarray,
               gt_boxes: np.ndarray, gt_classes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        new_boxes = [gt_boxes] if len(gt_boxes) else []
        new_classes = [gt_classes] if len(gt_classes) else []
        accepted: List[Dict] = []
        occupied = _bev(gt_boxes) if len(gt_boxes) \
            else np.zeros((0, 5), np.float32)

        for name, max_n in self.max_per_class.items():
            pool = self.db.get(name, [])
            if not pool:
                continue
            present = int(np.sum(gt_classes == self.class_ids[name])) \
                if len(gt_classes) else 0
            want = max(0, max_n - present)
            if want == 0:
                continue
            picks = rng.randint(0, len(pool), size=want * 2)
            taken = 0
            for pi in picks:
                if taken >= want:
                    break
                cand = pool[pi]
                bev = _bev(cand["box"][None])
                if len(occupied):
                    iou = host_ops.rotated_iou_matrix(bev, occupied)
                    if iou.max() > 1e-3:
                        continue
                occupied = np.concatenate([occupied, bev], 0)
                accepted.append(cand)
                new_boxes.append(cand["box"][None])
                new_classes.append(np.array([self.class_ids[name]], np.int32))
                taken += 1

        if not accepted:
            return points, gt_boxes, gt_classes

        sampled_bev = np.concatenate([_bev(c["box"][None]) for c in accepted])
        inside = host_ops.points_in_rboxes(points[:, :2], sampled_bev)
        scene = points[~inside.any(axis=1)]
        pasted = []
        for c in accepted:
            p = c["points"].copy()
            p[:, :3] += c["box"][:3]
            pasted.append(p)
        all_points = np.concatenate([scene] + pasted, 0)
        return (all_points.astype(np.float32),
                np.concatenate(new_boxes, 0).astype(np.float32),
                np.concatenate(new_classes, 0).astype(np.int32))
