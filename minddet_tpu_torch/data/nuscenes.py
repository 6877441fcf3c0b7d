"""nuScenes data: the raw v1.0 tables, per-keyframe infos, merged sweeps,
CBGS resampling, records, the global augmentation and the host examples
(counterpart of ``minddet_tpu/data/nuscenes.py``: ``infer_attributes``,
``quat_to_rot``, ``quat_multiply``, ``quat_inverse``, ``quaternion_yaw``,
``transform_matrix``, ``NuScenesTables``, ``box_velocity``,
``create_nuscenes_infos``, ``read_points_bin``, ``remove_close``,
``load_merged_sweeps``, ``cbgs_indices``, ``nuscenes_examples``,
``create_nuscenes_records``, ``global_augment_3d`` and
``NuScenesDetection``).

Host numpy, as the reference's: the tables are parsed from their JSON (no
devkit), velocities are finite differences of an instance's neighbouring
annotations, and past sweeps are moved into the keyframe's lidar frame
through ``ref_from_car @ car_from_global @ global_from_car @
car_from_current``. Boxes are (G, 9) f32 ``[x, y, z, w, l, h, vx, vy,
yaw]`` in the lidar frame, z at the box's centre, yaw the geometric
heading. Timestamps are microseconds in the tables and seconds in the
infos and records.

``NuScenesDetection`` reads record shards or holds records in memory (what
a host without ``array_record`` feeds it). One ``np.random.RandomState``
per dataset draws CBGS (in ``__init__``), the GT sampler, the global
augmentation and the subsample, as in the reference; the loader's threads
share it, so past one worker the batches depend on the thread schedule (a
fault of the reference that the port keeps).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from minddet_tpu_torch.data.records import RecordDataset, write_records

DETECTION_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

# the official attribute vocabulary; the index is the attribute's id
ATTRIBUTES = (
    "cycle.with_rider", "cycle.without_rider",
    "pedestrian.moving", "pedestrian.sitting_lying_down",
    "pedestrian.standing",
    "vehicle.moving", "vehicle.parked", "vehicle.stopped",
)

MOVING_ATTRIBUTE = {
    "car": "vehicle.moving", "truck": "vehicle.moving",
    "construction_vehicle": "vehicle.moving", "bus": "vehicle.moving",
    "trailer": "vehicle.moving",
    "motorcycle": "cycle.with_rider", "bicycle": "cycle.with_rider",
    "pedestrian": "pedestrian.moving",
}
STATIC_ATTRIBUTE = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "construction_vehicle": "vehicle.parked", "bus": "vehicle.stopped",
    "trailer": "vehicle.parked",
    "motorcycle": "cycle.without_rider", "bicycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
}


def infer_attributes(boxes9: np.ndarray, class_ids: np.ndarray,
                     speed_thresh: float = 0.2) -> np.ndarray:
    """CenterPoint's attribute rule from the predicted velocity: faster
    than ``speed_thresh`` m/s takes the class's moving attribute, else its
    static one. ``class_ids`` are 1-based into DETECTION_CLASSES; returns
    ids into ATTRIBUTES, -1 for classes without attributes (barrier,
    traffic_cone) and ids out of range."""
    speed = np.linalg.norm(np.asarray(boxes9)[:, 6:8], axis=1)
    out = np.full(len(boxes9), -1, np.int32)
    for i, cid in enumerate(np.asarray(class_ids)):
        if not 1 <= cid <= len(DETECTION_CLASSES):
            continue
        name = DETECTION_CLASSES[cid - 1]
        table = MOVING_ATTRIBUTE if speed[i] > speed_thresh \
            else STATIC_ATTRIBUTE
        attr = table.get(name)
        if attr is not None:
            out[i] = ATTRIBUTES.index(attr)
    return out


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix, f64."""
    w, x, y, z = q
    return np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
        np.float64)


def quat_multiply(a, b) -> np.ndarray:
    """Hamilton product a b of two (w, x, y, z) quaternions, f64."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], np.float64)


def quat_inverse(q) -> np.ndarray:
    """The conjugate of a unit quaternion (its inverse), f64."""
    w, x, y, z = q
    return np.array([w, -x, -y, -z], np.float64)


def quaternion_yaw(q) -> float:
    """The heading of the rotated x axis in the ground plane."""
    v = quat_to_rot(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse: bool = False
                     ) -> np.ndarray:
    """4x4 homogeneous transform, f64, from a translation and a quaternion
    (with ``inverse``, the transform back)."""
    tm = np.eye(4, dtype=np.float64)
    rot = quat_to_rot(rotation_q)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation, np.float64)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = translation
    return tm


class NuScenesTables:
    """The v1.0 JSON tables of ``root/version``, indexed by token, with each
    sample's keyframe ``sample_data`` by sensor channel and each sample's
    annotations."""

    TABLE_NAMES = (
        "sample", "sample_data", "ego_pose", "calibrated_sensor",
        "sample_annotation", "scene", "category", "attribute", "instance",
        "sensor",
    )

    def __init__(self, root: str, version: str = "v1.0-trainval"):
        self.root = root
        self.version = version
        base = os.path.join(root, version)
        self.tables: Dict[str, List[Dict]] = {}
        self.index: Dict[str, Dict[str, Dict]] = {}
        for name in self.TABLE_NAMES:
            with open(os.path.join(base, f"{name}.json")) as f:
                rows = json.load(f)
            self.tables[name] = rows
            self.index[name] = {r["token"]: r for r in rows}

        sensor_channel = {s["token"]: s["channel"]
                          for s in self.tables["sensor"]}
        self._sd_channel = {
            sd["token"]: sensor_channel[self.index["calibrated_sensor"][
                sd["calibrated_sensor_token"]]["sensor_token"]]
            for sd in self.tables["sample_data"]}
        self.sample_keyframes: Dict[str, Dict[str, Dict]] = {}
        for sd in self.tables["sample_data"]:
            if not sd.get("is_key_frame"):
                continue
            self.sample_keyframes.setdefault(sd["sample_token"], {})[
                self._sd_channel[sd["token"]]] = sd
        self.sample_anns: Dict[str, List[Dict]] = {}
        for ann in self.tables["sample_annotation"]:
            self.sample_anns.setdefault(ann["sample_token"], []).append(ann)

    def get(self, table: str, token: str) -> Dict:
        return self.index[table][token]

    def channel(self, sample_data_token: str) -> str:
        return self._sd_channel[sample_data_token]


def box_velocity(tables: NuScenesTables, ann: Dict,
                 max_time_diff: float = 1.5) -> np.ndarray:
    """Global-frame velocity (3,) f32 of an annotation: the difference of
    its instance's previous and next annotations (itself where one is
    missing) over their time apart; zeros with neither, or when that time
    is not in (0, ``max_time_diff``] s."""
    has_prev = bool(ann["prev"])
    has_next = bool(ann["next"])
    if not has_prev and not has_next:
        return np.zeros(3, np.float32)
    first = tables.get("sample_annotation", ann["prev"]) if has_prev else ann
    last = tables.get("sample_annotation", ann["next"]) if has_next else ann
    pos_diff = np.asarray(last["translation"]) - np.asarray(
        first["translation"])
    t_first = 1e-6 * tables.get("sample", first["sample_token"])["timestamp"]
    t_last = 1e-6 * tables.get("sample", last["sample_token"])["timestamp"]
    dt = t_last - t_first
    if dt > max_time_diff or dt <= 0:
        return np.zeros(3, np.float32)
    return (pos_diff / dt).astype(np.float32)


def create_nuscenes_infos(root: str, version: str = "v1.0-trainval",
                          nsweeps: int = 10, filter_zero: bool = True,
                          val_scene_names: Optional[Set[str]] = None
                          ) -> Tuple[List[Dict], List[Dict]]:
    """Per-keyframe infos (train, val): the keyframe's lidar file and time
    (s), ``nsweeps`` - 1 past sweeps (each its file, the f32 transform into
    the keyframe's lidar frame, and its time lag; the keyframe itself
    repeated where the scene has none, the last one repeated where it has
    too few), the scene, ``global_from_lidar`` and the lidar-frame GT:
    boxes with their velocity, names, attribute ids, lidar point counts
    and track ids (one per instance, in order of first appearance).
    Annotations of ignored categories, and with ``filter_zero`` those with
    no lidar or radar point, are dropped. Scenes named in
    ``val_scene_names`` go to val."""
    tables = NuScenesTables(root, version)
    val_scene_names = val_scene_names or set()
    val_scene_tokens = {s["token"] for s in tables.tables["scene"]
                        if s["name"] in val_scene_names}
    train_infos, val_infos = [], []
    instance_ids: Dict[str, int] = {}

    for sample in tables.tables["sample"]:
        key = tables.sample_keyframes.get(sample["token"], {})
        if "LIDAR_TOP" not in key:
            continue
        ref_sd = key["LIDAR_TOP"]
        ref_cs = tables.get("calibrated_sensor",
                            ref_sd["calibrated_sensor_token"])
        ref_pose = tables.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_from_car = transform_matrix(ref_cs["translation"],
                                        ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"],
                                           ref_pose["rotation"], inverse=True)

        sweeps: List[Dict] = []
        curr = ref_sd
        while len(sweeps) < nsweeps - 1:
            if not curr["prev"]:
                if not sweeps:
                    sweeps.append({"lidar_path": ref_sd["filename"],
                                   "transform_matrix": None,
                                   "time_lag": 0.0})
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = tables.get("sample_data", curr["prev"])
                pose = tables.get("ego_pose", curr["ego_pose_token"])
                cs = tables.get("calibrated_sensor",
                                curr["calibrated_sensor_token"])
                global_from_car = transform_matrix(pose["translation"],
                                                   pose["rotation"])
                car_from_current = transform_matrix(cs["translation"],
                                                    cs["rotation"])
                tm = (ref_from_car @ car_from_global @ global_from_car
                      @ car_from_current)
                sweeps.append({
                    "lidar_path": curr["filename"],
                    "transform_matrix": tm.astype(np.float32),
                    "time_lag": float(ref_time - 1e-6 * curr["timestamp"])})

        info = {
            "token": sample["token"],
            "lidar_path": ref_sd["filename"],
            "timestamp": ref_time,
            "sweeps": sweeps,
            "scene_token": sample["scene_token"],
            "global_from_lidar": (
                transform_matrix(ref_pose["translation"],
                                 ref_pose["rotation"])
                @ transform_matrix(ref_cs["translation"],
                                   ref_cs["rotation"])).astype(np.float32),
        }

        anns = tables.sample_anns.get(sample["token"], [])
        q_pose_inv = quat_inverse(ref_pose["rotation"])
        q_cs_inv = quat_inverse(ref_cs["rotation"])
        r_pose_inv = quat_to_rot(ref_pose["rotation"]).T
        r_cs_inv = quat_to_rot(ref_cs["rotation"]).T
        boxes, names, attrs, npts, tids = [], [], [], [], []
        for ann in anns:
            instance = tables.get("instance", ann["instance_token"])
            cat = tables.get("category", instance["category_token"])["name"]
            det_name = GENERAL_TO_DETECTION.get(cat, "ignore")
            if det_name == "ignore":
                continue
            if filter_zero and (ann.get("num_lidar_pts", 0)
                                + ann.get("num_radar_pts", 0) == 0):
                continue
            c = np.asarray(ann["translation"], np.float64)
            c = r_pose_inv @ (c - np.asarray(ref_pose["translation"]))
            c = r_cs_inv @ (c - np.asarray(ref_cs["translation"]))
            q = quat_multiply(q_cs_inv, quat_multiply(q_pose_inv,
                                                      ann["rotation"]))
            yaw = quaternion_yaw(q)
            w, l, h = ann["size"]
            v_global = box_velocity(tables, ann)
            v = r_cs_inv @ (r_pose_inv @ v_global.astype(np.float64))
            boxes.append([c[0], c[1], c[2], w, l, h, v[0], v[1], yaw])
            names.append(det_name)
            attr_tokens = ann.get("attribute_tokens", [])
            if attr_tokens:
                attr_name = tables.get("attribute", attr_tokens[0])["name"]
                attrs.append(ATTRIBUTES.index(attr_name)
                             if attr_name in ATTRIBUTES else -1)
            else:
                attrs.append(-1)
            npts.append(int(ann.get("num_lidar_pts", 0)))
            tids.append(instance_ids.setdefault(ann["instance_token"],
                                                len(instance_ids)))

        info["gt_boxes"] = (np.asarray(boxes, np.float32) if boxes
                            else np.zeros((0, 9), np.float32))
        info["gt_names"] = names
        info["gt_attrs"] = np.asarray(attrs, np.int32)
        info["num_lidar_pts"] = np.asarray(npts, np.int32)
        info["gt_track_ids"] = np.asarray(tids, np.int32)

        if sample["scene_token"] in val_scene_tokens:
            val_infos.append(info)
        else:
            train_infos.append(info)
    return train_infos, val_infos


def read_points_bin(path: str) -> np.ndarray:
    """A nuScenes ``.pcd.bin`` -> (N, 5) f32 [x, y, z, intensity, ring]."""
    return np.fromfile(path, np.float32).reshape(-1, 5)


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """The points outside the ``radius`` square about the sensor (the ego
    vehicle's own returns dropped)."""
    keep = ~((np.abs(points[:, 0]) < radius)
             & (np.abs(points[:, 1]) < radius))
    return points[keep]


def load_merged_sweeps(info: Dict, root: str, nsweeps: int = 10
                       ) -> np.ndarray:
    """The keyframe's cloud and ``nsweeps`` - 1 past sweeps (close returns
    removed, moved into the keyframe's lidar frame by their transform)
    -> (N, 5) f32 [x, y, z, intensity, time lag]."""
    ref = read_points_bin(os.path.join(root, info["lidar_path"]))
    out = [np.concatenate([ref[:, :4], np.zeros((len(ref), 1), np.float32)],
                          -1)]
    for sweep in info["sweeps"][: max(0, nsweeps - 1)]:
        pts = read_points_bin(os.path.join(root, sweep["lidar_path"]))
        pts = remove_close(pts)
        tm = sweep["transform_matrix"]
        if tm is not None:
            xyz1 = np.concatenate([pts[:, :3],
                                   np.ones((len(pts), 1), np.float32)], -1)
            pts = pts.copy()
            pts[:, :3] = (xyz1 @ np.asarray(tm, np.float32).T)[:, :3]
        dt = np.full((len(pts), 1), sweep["time_lag"], np.float32)
        out.append(np.concatenate([pts[:, :4], dt], -1))
    return np.concatenate(out, 0).astype(np.float32)


def cbgs_indices(class_sets: Sequence[Set[str]],
                 class_names: Sequence[str] = DETECTION_CLASSES,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Class-balanced grouping and sampling: per class of ``class_names``
    (in order) with samples, ``max(1, floor(n_c * ratio))`` indices drawn
    with replacement (``rng.choice``) from the samples holding it, where
    ``ratio`` brings each class to 1 / len(class_names) of the duplicated
    epoch. ``class_sets[i]`` is the set of class names in sample i; with
    no class anywhere, every index once."""
    rng = rng or np.random.RandomState(0)
    cls_idx = {name: np.asarray([i for i, s in enumerate(class_sets)
                                 if name in s], np.int64)
               for name in class_names}
    duplicated = sum(len(v) for v in cls_idx.values())
    if duplicated == 0:
        return np.arange(len(class_sets), dtype=np.int64)
    frac = 1.0 / len(class_names)
    out = []
    for name in class_names:
        idx = cls_idx[name]
        if len(idx) == 0:
            continue
        ratio = frac / (len(idx) / duplicated)
        out.append(rng.choice(idx, max(1, int(len(idx) * ratio))))
    return np.concatenate(out) if out else np.arange(len(class_sets),
                                                     dtype=np.int64)


def _token_bytes(token: str) -> np.ndarray:
    return np.frombuffer(token.encode().ljust(32)[:32], np.uint8).copy()


def nuscenes_examples(infos: Sequence[Dict], root: str, nsweeps: int = 10
                      ) -> Iterator[Dict[str, Any]]:
    """Each info's record: merged points, gt_boxes, gt_classes (1-based
    into DETECTION_CLASSES), gt_attrs, the token (32 bytes) and, where the
    info has a scene, the tracking metadata: scene (32 bytes), timestamp
    (f64 s), global_from_lidar (4, 4) f32 and gt_track_ids."""
    name_to_id = {c: i + 1 for i, c in enumerate(DETECTION_CLASSES)}
    for info in infos:
        ex = {
            "points": load_merged_sweeps(info, root, nsweeps),
            "gt_boxes": info["gt_boxes"],
            "gt_classes": np.asarray([name_to_id[n]
                                      for n in info["gt_names"]], np.int32),
            "gt_attrs": info["gt_attrs"],
            "token": _token_bytes(info["token"]),
        }
        if "scene_token" in info:
            ex["scene"] = _token_bytes(info["scene_token"])
            ex["timestamp"] = np.float64(info["timestamp"])
            ex["global_from_lidar"] = np.asarray(
                info["global_from_lidar"], np.float32).reshape(4, 4)
            ex["gt_track_ids"] = np.asarray(info["gt_track_ids"], np.int32)
        yield ex


def create_nuscenes_records(root: str, out_prefix: str,
                            version: str = "v1.0-trainval",
                            nsweeps: int = 10, split: str = "train",
                            val_scene_names: Optional[Set[str]] = None
                            ) -> List[str]:
    """The split's infos written as record shards under ``out_prefix``
    (``nuscenes_examples``), and beside them ``<out_prefix>-classsets.json``
    with each sample's class names, which CBGS reads. Returns the shard
    paths."""
    train_infos, val_infos = create_nuscenes_infos(
        root, version, nsweeps, val_scene_names=val_scene_names)
    infos = train_infos if split == "train" else val_infos
    paths = write_records(out_prefix, nuscenes_examples(infos, root,
                                                        nsweeps))
    with open(out_prefix + "-classsets.json", "w") as f:
        json.dump([sorted(set(i["gt_names"])) for i in infos], f)
    return paths


def global_augment_3d(rng: np.random.RandomState, points: np.ndarray,
                      boxes: np.ndarray, rot_range=(-np.pi / 8, np.pi / 8),
                      scale_range=(0.95, 1.05), flip_prob: float = 0.5,
                      translate_std=(0.2, 0.2, 0.2)) -> tuple:
    """The scene and its 9-wide boxes flipped over the x axis, then over
    the y axis (each with ``flip_prob``), rotated about z, scaled and
    translated, drawn in that order. The velocity goes with the scene: a
    flip negates its matching component (the y flip negates yaw, the x
    flip sets it to pi - yaw), the rotation rotates (vx, vy) and adds the
    angle to yaw, the scale multiplies the first eight columns."""
    points = points.copy()
    boxes = boxes.copy() if len(boxes) else boxes
    if rng.rand() < flip_prob:
        points[:, 1] = -points[:, 1]
        if len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 7] = -boxes[:, 7]
            boxes[:, 8] = -boxes[:, 8]
    if rng.rand() < flip_prob:
        points[:, 0] = -points[:, 0]
        if len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -boxes[:, 6]
            boxes[:, 8] = np.pi - boxes[:, 8]
    ang = rng.uniform(*rot_range)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]], np.float32)
    points[:, :2] = points[:, :2] @ rot.T
    if len(boxes):
        boxes[:, :2] = boxes[:, :2] @ rot.T
        boxes[:, 6:8] = boxes[:, 6:8] @ rot.T
        boxes[:, 8] += ang
    sc = rng.uniform(*scale_range)
    points[:, :3] *= sc
    if len(boxes):
        boxes[:, :8] *= sc
    t = rng.normal(scale=translate_std, size=3).astype(np.float32)
    points[:, :3] += t
    if len(boxes):
        boxes[:, :3] += t
    return points, boxes


TRACKING_KEYS = ("scene", "timestamp", "global_from_lidar", "gt_track_ids")


def _class_sets(records, pattern: Optional[str]) -> List[Set[str]]:
    """Each record's class names: from the ``-classsets.json`` beside a
    shard pattern where it exists, else scanned from the records."""
    if pattern is not None:
        sidecar = pattern.split("-*")[0].split("*")[0].rstrip("-")
        path = sidecar + "-classsets.json"
        if os.path.exists(path):
            with open(path) as f:
                return [set(s) for s in json.load(f)]
    return [{DETECTION_CLASSES[c - 1] for c in records[i]["gt_classes"]
             if c >= 1} for i in range(len(records))]


class NuScenesDetection:
    """nuScenes records as fixed-shape host examples: points (max_points,
    5) zero-padded (a random subsample where the cloud has more),
    points_mask, gt_boxes (max_gt, 9), gt_classes (1-based into
    DETECTION_CLASSES), gt_attrs (-1 where unlabelled), gt_mask, and where
    the records carry them the tracking keys (TRACKING_KEYS; track id -1 in
    slots of pasted or padded boxes).

    ``records``: a shard pattern or a list of shard paths (read through
    ``RecordDataset``), a record dataset, or a sequence of record dicts in
    memory. With ``cbgs`` the epoch is the CBGS resampling
    (``cbgs_indices``, drawn in ``__init__``) of the records' class sets
    (``_class_sets``). With ``gt_sampler`` and ``augment`` set,
    ``__getitem__`` runs the reference's training recipe in order: paste
    database objects (their attribute -1), then the global flip / rotate /
    scale / translate; all draws from one ``RandomState(seed)``."""

    def __init__(self, records, max_points: int = 120000, max_gt: int = 500,
                 cbgs: bool = False, augment: bool = False, gt_sampler=None,
                 seed: int = 0):
        pattern = records if isinstance(records, str) else None
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
        self._indices = np.arange(len(self.records))
        if cbgs:
            self._indices = cbgs_indices(_class_sets(self.records, pattern),
                                         rng=self._rng)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[int(self._indices[idx])]
        points = rec["points"]
        boxes = rec["gt_boxes"].reshape(-1, 9)
        classes = rec["gt_classes"]
        attrs = rec.get("gt_attrs", np.full(len(classes), -1, np.int32))
        if self.gt_sampler is not None:
            n_before = len(boxes)
            points, boxes, classes = self.gt_sampler.sample(
                self._rng, points, boxes, classes)
            attrs = np.concatenate(
                [attrs, np.full(len(boxes) - n_before, -1, np.int32)])
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
        ga = np.full((self.max_gt,), -1, np.int32)
        gm = np.zeros((self.max_gt,), bool)
        gb[:g] = boxes[:g]
        gc[:g] = classes[:g]
        ga[:g] = attrs[:g]
        gm[:g] = True
        out = {"points": p, "points_mask": np.arange(self.max_points) < n,
               "gt_boxes": gb, "gt_classes": gc, "gt_attrs": ga,
               "gt_mask": gm}
        if "scene" in rec:
            out["scene"] = rec["scene"]
            out["timestamp"] = np.float64(rec["timestamp"])
            out["global_from_lidar"] = np.asarray(
                rec["global_from_lidar"], np.float32).reshape(4, 4)
            tid = np.full((self.max_gt,), -1, np.int32)
            src = rec["gt_track_ids"].reshape(-1)[:g]
            tid[: len(src)] = src
            out["gt_track_ids"] = tid
        return out
