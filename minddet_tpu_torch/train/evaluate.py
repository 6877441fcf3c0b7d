"""Evaluation (counterpart of ``minddet_tpu/train/evaluate.py``:
``_pad_batch``, the COCO paths ``coco_evaluate`` and ``centernet_evaluate``
with ``_keep_res_hw`` and ``_soft_nms_per_class``, the KITTI path
``kitti_evaluate``, the nuScenes paths ``nuscenes_evaluate`` and
``nuscenes_tracking_evaluate``, the Waymo path ``waymo_evaluate`` with
``WAYMO_EVAL_NAMES``, and the segmentation mIoU,
``segmentation_evaluate``).

The device runs the warp (the row-gather kernel K3f on the card), the
model's ``predict`` and the soft-NMS; the host accumulates the protocol's
metrics (``data/coco_eval.py``). A COCO evaluation takes a record pattern,
as the reference's does, or records in memory, or a dataset with
``CocoDetection``'s interface (``records[i]["hw"]``, ``__getitem__``,
``__len__``). The KITTI evaluation predicts on the model's device (the
rotated NMS through K4), projects the detections to the camera and the
image on the host, and computes the official table with
``data/kitti_eval.py`` (its overlaps on the model's device). The nuScenes
evaluations predict on the model's device (the rotated NMS through K4) and
run the protocol's matching, the tracker and the tracking protocol on the
host (``data/nuscenes_eval.py``, ``track.py``,
``data/nuscenes_track_eval.py``). The Waymo evaluation predicts on the
model's device and runs the protocol's IoUs there too (``data/
waymo_eval.py``: K4 on the card), its matching on the host.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from minddet_tpu_torch.data.coco import (CocoDetection,
                                         evaluate_coco_detections,
                                         paste_masks_to_image)
from minddet_tpu_torch.data.kitti import (KittiDetection,
                                          detections_to_kitti_annos,
                                          kitti_gt_anno)
from minddet_tpu_torch.data.kitti_eval import get_official_eval_result
from minddet_tpu_torch.data.nuscenes import (DETECTION_CLASSES,
                                             TRACKING_KEYS,
                                             NuScenesDetection,
                                             infer_attributes)
from minddet_tpu_torch.data.nuscenes_eval import evaluate_nuscenes
from minddet_tpu_torch.data.nuscenes_track_eval import evaluate_tracking
from minddet_tpu_torch.data.seg import SegDataset
from minddet_tpu_torch.data.waymo import WaymoDetection
from minddet_tpu_torch.data.waymo_eval import evaluate_waymo
from minddet_tpu_torch.data.transforms import eval_affine, warp_images
from minddet_tpu_torch.ops.nms import soft_nms
from minddet_tpu_torch.track import track_sequence


def _pad_batch(arrays: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a stacked host batch to ``batch_size`` rows by repeating the
    last, so every predict call has one shape; callers keep the real rows
    of the output (the tail images stay in the protocol)."""
    pad = batch_size - arrays.shape[0]
    if pad <= 0:
        return arrays
    return np.concatenate([arrays, np.repeat(arrays[-1:], pad, axis=0)], 0)


@torch.no_grad()
def segmentation_evaluate(model: nn.Module, records: str, num_classes: int,
                          batch_size: int = 8, max_images: int = 0
                          ) -> Dict[str, float]:
    """mIoU of ``model.predict`` over segmentation records (``SegDataset``
    without augmentation: the train path's normalization; ignored pixels
    left out): per class, intersection and union summed over the dataset
    (the first ``max_images`` where positive), their ratio averaged over
    the classes present in either. Batches of ``batch_size``, the tail
    padded (``_pad_batch``), run on the model's device as it is (eval
    mode for served weights)."""
    ds = SegDataset(records, augment=False)
    n = min(len(ds), max_images) if max_images else len(ds)
    dev = next(model.parameters()).device
    inter = np.zeros(num_classes)
    union = np.zeros(num_classes)
    for start in range(0, n, batch_size):
        recs = [ds[i] for i in range(start, min(start + batch_size, n))]
        images = _pad_batch(np.stack([r["image"] for r in recs]), batch_size)
        pred = model.predict(torch.from_numpy(images).to(dev))
        pred = pred[: len(recs)].cpu().numpy()
        target = np.stack([r["mask"] for r in recs])
        valid = np.stack([r["valid"] for r in recs])
        for c in range(num_classes):
            inter[c] += np.sum((pred == c) & (target == c) & valid)
            union[c] += np.sum(((pred == c) | (target == c)) & valid)
    per_class = inter / np.maximum(union, 1)
    present = union > 0
    return {"miou": float(per_class[present].mean()) if present.any()
            else 0.0}


def coco_dataset(records, **kwargs) -> CocoDetection:
    """``records`` itself where it is a dataset, else ``CocoDetection`` of
    it (a shard pattern, a list of shard paths or records in memory) with
    ``kwargs``."""
    if isinstance(records, (str, list, tuple)):
        return CocoDetection(records, **kwargs)
    return records


class _Laps:
    """Seconds by part into ``timings`` (None: nothing is timed, nothing
    synchronised): ``lap(name)`` waits for ``dev`` and adds the time since
    the last lap under ``name``."""

    def __init__(self, timings: Optional[Dict[str, float]], dev):
        self.timings, self.dev = timings, dev
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now


@torch.no_grad()
def coco_evaluate(model: nn.Module, records, image_hw: Tuple[int, int],
                  num_classes: int, batch_size: int = 8, segm: bool = False
                  ) -> Dict[str, float]:
    """The fixed-resolution COCO path (the 2D zoo): each image warped to
    ``image_hw`` (``eval_affine``: the longer side fit, centred), the
    model's ``predict`` on its device (the tail batch padded,
    ``_pad_batch``), the boxes mapped back to the image's pixels, the 12
    COCO numbers over ``records`` (``coco_dataset``, 128 slots). ``predict`` returns a dict
    (boxes, scores, labels in input pixels, and masks) or CenterNet's (B,
    K, 6) at output stride 4. With ``segm`` (Mask R-CNN) the roi masks are
    pasted at the image's resolution (``paste_masks_to_image``) and scored
    by mask IoU too, under ``segm_`` names."""
    ds = coco_dataset(records, max_objs=128, keep_raw=True)
    n = len(ds)
    dev = next(model.parameters()).device
    predictions = {}
    for start in range(0, n, batch_size):
        exs = [ds[i] for i in range(start, min(start + batch_size, n))]
        images = torch.from_numpy(_pad_batch(
            np.stack([e["image"] for e in exs]), batch_size)).to(dev)
        hw = torch.from_numpy(_pad_batch(
            np.stack([e["hw"] for e in exs]), batch_size)).to(dev)
        aff = eval_affine(hw, image_hw)
        out = model.predict(warp_images(images, aff, tuple(image_hw)))
        roi_masks = None
        if isinstance(out, dict):
            boxes = out["boxes"].double().cpu().numpy()
            scores = out["scores"].double().cpu().numpy()
            labels = out["labels"].long().cpu().numpy()
            if segm:
                roi_masks = out["masks"].float().cpu().numpy()
        else:  # CenterNet: (B, K, 6) at output stride 4
            det = out.double().cpu().numpy()
            boxes = det[..., :4] * 4.0
            scores = det[..., 4]
            labels = det[..., 5].astype(np.int64)
        fwd = aff.cpu().numpy()  # output -> input: back to the image
        for bi, ex in enumerate(exs):
            m, b = fwd[bi], boxes[bi]
            pred = {"boxes": np.stack([m[0, 0] * b[:, 0] + m[0, 2],
                                       m[1, 1] * b[:, 1] + m[1, 2],
                                       m[0, 0] * b[:, 2] + m[0, 2],
                                       m[1, 1] * b[:, 3] + m[1, 2]], -1),
                    "scores": scores[bi], "labels": labels[bi]}
            if roi_masks is not None:
                pred["masks"] = paste_masks_to_image(
                    roi_masks[bi], pred["boxes"], int(ex["hw"][0]),
                    int(ex["hw"][1]))
            predictions[int(ex["image_id"])] = pred
    stats = evaluate_coco_detections(ds, predictions, num_classes)
    if segm:
        mask_stats = evaluate_coco_detections(ds, predictions, num_classes,
                                              segm=True)
        stats.update({f"segm_{k}": v for k, v in mask_stats.items()})
    return stats


# CenterNet's own protocol: keep-res padding at scale 1, per-class soft-NMS,
# the top-100 cross-class merge
MAX_PER_IMAGE = 100  # detections kept by the merge (ties may keep more)
DOWN_RATIO = 4       # the heads' output stride
SOFT_NMS_CAP = 128   # slots per class
KEEP_RES_BUCKET = 128  # canvas sides rounded up to a multiple of this
EVAL_BATCH = 4       # images per predict call


def _keep_res_hw(h: int, w: int) -> Tuple[int, int]:
    """The reference's keep-res padding ``(dim | 31) + 1`` of the image,
    rounded up to a multiple of ``KEEP_RES_BUCKET`` so one program serves
    a bucket (the centred placement pads, never resizes)."""
    b = KEEP_RES_BUCKET
    ih, iw = (h | 31) + 1, (w | 31) + 1
    return -(-ih // b) * b, -(-iw // b) * b


def _soft_nms_per_class(boxes: np.ndarray, scores: np.ndarray,
                        labels: np.ndarray, num_classes: int,
                        cap: int = SOFT_NMS_CAP, device="cpu"
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class Gaussian soft-NMS (sigma 0.5, score threshold 1e-3) of one
    image's detections, every class in one ``soft_nms`` call on ``device``
    over (num_classes, cap) slots: each class's detections (its ``cap``
    best where it has more) in its row, empty slots score 0. Returns the
    boxes, rescored scores and labels that stay above 0, class by
    class."""
    cls_boxes = np.zeros((num_classes, cap, 4), np.float32)
    cls_scores = np.zeros((num_classes, cap), np.float32)
    for j in range(num_classes):
        sel = np.nonzero(labels == j)[0]
        if len(sel) > cap:
            sel = sel[np.argsort(-scores[sel])[:cap]]
        cls_boxes[j, :len(sel)] = boxes[sel]
        cls_scores[j, :len(sel)] = scores[sel]
    new_scores = soft_nms(torch.from_numpy(cls_boxes).to(device),
                          torch.from_numpy(cls_scores).to(device),
                          sigma=0.5, score_threshold=1e-3)[0].cpu().numpy()
    out_b, out_s, out_l = [], [], []
    for j in range(num_classes):
        keep = new_scores[j] > 0
        out_b.append(cls_boxes[j][keep])
        out_s.append(new_scores[j][keep])
        out_l.append(np.full(int(keep.sum()), j, np.int64))
    return np.concatenate(out_b), np.concatenate(out_s), np.concatenate(out_l)


@torch.no_grad()
def centernet_evaluate(model: nn.Module, records, num_classes: int = 80,
                       timings: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
    """The reference's CenterNet protocol at scale 1: each image placed
    centred (never resized) on its keep-res canvas (``_keep_res_hw``),
    images grouped by canvas and predicted ``EVAL_BATCH`` at a time (a
    bucket's tail padded with zero images), the boxes (at ``DOWN_RATIO``)
    mapped back; per image, per-class soft-NMS on the model's device
    (``_soft_nms_per_class``), then the cross-class merge keeping every
    score at or above the ``MAX_PER_IMAGE``-th (ties may keep more); the 12
    COCO numbers over ``records`` (``coco_dataset`` on a (1024, 1024)
    canvas, 128 slots). With ``timings`` the device is waited for between
    parts, and their seconds are added there: load (host examples), copy
    (to the device), warp, predict (with the detections back to the host),
    soft_nms, evaluate (the host's protocol)."""
    ds = coco_dataset(records, max_hw=(1024, 1024), max_objs=128,
                      keep_raw=True)
    dev = next(model.parameters()).device
    laps = _Laps(timings, dev)
    raw = defaultdict(lambda: ([], [], []))
    groups = defaultdict(list)
    for i in range(len(ds)):  # the stored sizes: no image decoded yet
        h, w = ds.records[i]["hw"]
        groups[_keep_res_hw(int(h), int(w))].append(i)
    for (ih, iw), items in groups.items():
        for start in range(0, len(items), EVAL_BATCH):
            exs = [ds[i] for i in items[start:start + EVAL_BATCH]]
            images = np.stack([e["image"] for e in exs])
            affs = np.zeros((len(exs), 2, 3), np.float32)
            offsets = []
            for bi, e in enumerate(exs):
                h, w = e["hw"]
                ox, oy = (iw - w) / 2.0, (ih - h) / 2.0
                affs[bi] = [[1, 0, -ox], [0, 1, -oy]]
                offsets.append((ox, oy))
            laps.lap("load")
            pad = EVAL_BATCH - len(exs)
            images = torch.from_numpy(images).to(dev)
            if pad:  # one shape per bucket
                images = torch.cat([images, images.new_zeros(
                    (pad,) + images.shape[1:])])
                affs = np.concatenate([affs, np.tile(affs[-1:], (pad, 1, 1))])
            affs = torch.from_numpy(affs).to(dev)
            laps.lap("copy")
            warped = warp_images(images, affs, (ih, iw))
            laps.lap("warp")
            det = model.predict(warped).double().cpu().numpy()[:len(exs)]
            laps.lap("predict")
            for bi, e in enumerate(exs):
                ox, oy = offsets[bi]
                b = det[bi, :, :4] * DOWN_RATIO
                bb, ss, ll = raw[int(e["image_id"])]
                bb.append(np.stack([b[:, 0] - ox, b[:, 1] - oy,
                                    b[:, 2] - ox, b[:, 3] - oy], -1))
                ss.append(det[bi, :, 4])
                ll.append(det[bi, :, 5].astype(np.int64))
            laps.lap("load")

    predictions = {}
    for img_id, (bb, ss, ll) in raw.items():
        boxes, scores, labels = _soft_nms_per_class(
            np.concatenate(bb).astype(np.float32),
            np.concatenate(ss).astype(np.float32), np.concatenate(ll),
            num_classes, device=dev)
        if len(scores) > MAX_PER_IMAGE:  # the top-100 merge
            kth = len(scores) - MAX_PER_IMAGE
            keep = scores >= np.partition(scores, kth)[kth]
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        predictions[img_id] = {"boxes": boxes, "scores": scores,
                               "labels": labels}
    laps.lap("soft_nms")
    stats = evaluate_coco_detections(ds, predictions, num_classes)
    laps.lap("evaluate")
    return stats


# KITTI: the official table, camera-frame bbox AP and AOS included
KITTI_SCORE_THRESHOLD = 0.3  # detections kept for the protocol
KITTI_EVAL_BATCH = 4


def kitti_dataset(records) -> KittiDetection:
    """``records`` itself where it is a dataset, else ``KittiDetection`` of
    it (a shard pattern, a list of shard paths or records in memory) with
    the raw labels kept."""
    if isinstance(records, (str, list, tuple)):
        return KittiDetection(records, keep_raw=True)
    return records


@torch.no_grad()
def kitti_evaluate(model: nn.Module, records,
                   classes: Sequence[str] = ("Car",),
                   timings: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Dict]:
    """PointPillars -> the official KITTI table (bbox, bev, 3d and AOS)
    over ``records`` (``kitti_dataset``): ``predict_from_points`` on the
    model's device, KITTI_EVAL_BATCH frames a call (the tail padded,
    ``_pad_batch``); the detections above KITTI_SCORE_THRESHOLD projected
    to camera and image frames (``detections_to_kitti_annos``); the GT
    annos from the records' camera-frame labels (``kitti_gt_anno``);
    ``get_official_eval_result`` with its overlaps on the model's device.
    With ``timings`` the device is waited for between parts, and their
    seconds are added there: load (host examples), copy, predict (with the
    detections back on the host), annos, overlaps and evaluate (the host's
    bookkeeping)."""
    ds = kitti_dataset(records)
    n = len(ds)
    dev = next(model.parameters()).device
    laps = _Laps(timings, dev)
    gt_annos, dt_annos = [], []
    for start in range(0, n, KITTI_EVAL_BATCH):
        exs = [ds[i] for i in range(start, min(start + KITTI_EVAL_BATCH, n))]
        pts = _pad_batch(np.stack([e["points"] for e in exs]),
                         KITTI_EVAL_BATCH)
        msk = _pad_batch(np.stack([e["points_mask"] for e in exs]),
                         KITTI_EVAL_BATCH)
        laps.lap("load")
        pts, msk = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
        laps.lap("copy")
        out = model.predict_from_points(pts, msk)
        boxes = out["boxes"].cpu().numpy()
        scores = out["scores"].cpu().numpy()
        labels = out["labels"].cpu().numpy()
        laps.lap("predict")
        for bi, ex in enumerate(exs):
            gt_annos.append(kitti_gt_anno(ex))
            keep = scores[bi] > KITTI_SCORE_THRESHOLD
            dt_annos.append(detections_to_kitti_annos(
                boxes[bi][keep], scores[bi][keep], labels[bi][keep], classes,
                np.asarray(ex["Trv2c_rect"]), np.asarray(ex["P2"]),
                np.asarray(ex["img_shape"])))
        laps.lap("annos")
    return get_official_eval_result(gt_annos, dt_annos, classes=classes,
                                    compute_aos=True, device=dev,
                                    timings=timings)


# nuScenes: mAP / NDS (the attribute term by the velocity rule) and AMOTA
NUSC_EVAL_BATCH = 2
NUSC_SCORE_THRESHOLD = 0.1  # detections kept for the protocols
NUSC_FRAME_KEYS = ("gt_boxes", "gt_classes", "gt_attrs", "gt_mask") \
    + TRACKING_KEYS


def nuscenes_dataset(records) -> NuScenesDetection:
    """``records`` itself where it is a dataset, else ``NuScenesDetection``
    of it (a shard pattern, a list of shard paths or records in memory)
    without CBGS or augmentation."""
    if isinstance(records, (str, list, tuple)):
        return NuScenesDetection(records, cbgs=False, augment=False)
    return records


def nuscenes_route(model: nn.Module, tta: bool = False,
                   refined: bool = False):
    """The predict method of a nuScenes evaluation: ``predict_refined``
    with ``refined`` (a two-stage model, else ValueError),
    ``predict_tta_double_flip`` with ``tta``, else
    ``predict_from_points``."""
    if refined:
        if not hasattr(model, "predict_refined"):
            raise ValueError("refined=True needs a two-stage model "
                             "(CenterPointTwoStage)")
        return model.predict_refined
    return model.predict_tta_double_flip if tta else model.predict_from_points


@torch.no_grad()
def nuscenes_detections(model: nn.Module, records, tta: bool = False,
                        refined: bool = False,
                        timings: Optional[Dict[str, float]] = None
                        ) -> List[Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]]:
    """Per frame of ``records`` (``nuscenes_dataset``), in order: (its
    example's GT and tracking keys, NUSC_FRAME_KEYS; its detections above
    NUSC_SCORE_THRESHOLD: boxes (n, 9), scores, labels 0-based into
    DETECTION_CLASSES). The route's method (``nuscenes_route``) runs on the
    model's device, NUSC_EVAL_BATCH frames a call, the tail padded
    (``_pad_batch``). With ``timings`` the device is waited for between
    parts, and their seconds are added there: load (host examples), copy
    and predict (with the detections back on the host)."""
    ds = nuscenes_dataset(records)
    n = len(ds)
    if n == 0:
        raise ValueError("need at least one frame")
    method = nuscenes_route(model, tta, refined)
    dev = next(model.parameters()).device
    laps = _Laps(timings, dev)
    frames = []
    for start in range(0, n, NUSC_EVAL_BATCH):
        exs = [ds[i] for i in range(start, min(start + NUSC_EVAL_BATCH, n))]
        pts = _pad_batch(np.stack([e["points"] for e in exs]),
                         NUSC_EVAL_BATCH)
        msk = _pad_batch(np.stack([e["points_mask"] for e in exs]),
                         NUSC_EVAL_BATCH)
        laps.lap("load")
        pts, msk = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
        laps.lap("copy")
        out = method(pts, msk)
        boxes = out["boxes"].cpu().numpy()
        scores = out["scores"].cpu().numpy()
        labels = out["labels"].cpu().numpy()
        laps.lap("predict")
        for bi, ex in enumerate(exs):
            keep = scores[bi] > NUSC_SCORE_THRESHOLD
            frames.append(({k: ex[k] for k in NUSC_FRAME_KEYS if k in ex},
                           {"boxes": boxes[bi][keep],
                            "scores": scores[bi][keep],
                            "labels": labels[bi][keep]}))
    return frames


def nuscenes_metrics(frames) -> Dict[str, float]:
    """``evaluate_nuscenes`` over ``nuscenes_detections``' frames, per
    class: the GT boxes and attributes of each frame, its detections with
    attributes by ``infer_attributes``."""
    gt_by_class = {c: [] for c in DETECTION_CLASSES}
    dt_by_class = {c: [] for c in DETECTION_CLASSES}
    for ex, det in frames:
        gm = ex["gt_mask"]
        attrs = infer_attributes(det["boxes"], det["labels"] + 1)
        for ci, cls in enumerate(DETECTION_CLASSES):
            g = ex["gt_classes"][gm] == ci + 1
            gt_by_class[cls].append({"boxes": ex["gt_boxes"][gm][g],
                                     "attrs": ex["gt_attrs"][gm][g]})
            d = det["labels"] == ci
            dt_by_class[cls].append({"boxes": det["boxes"][d],
                                     "scores": det["scores"][d],
                                     "attrs": attrs[d]})
    return evaluate_nuscenes(gt_by_class, dt_by_class, DETECTION_CLASSES)


def nuscenes_evaluate(model: nn.Module, records, tta: bool = False,
                      refined: bool = False,
                      timings: Optional[Dict[str, float]] = None
                      ) -> Dict[str, float]:
    """CenterPoint -> the nuScenes detection protocol (mAP over {0.5, 1,
    2, 4} m, mATE, mASE, mAOE, mAVE, mAAE with attributes by the velocity
    rule, NDS, AP per class) over ``records``: ``nuscenes_detections`` on
    the route (``predict_from_points``; ``tta``: double-flip TTA;
    ``refined``: the two-stage ``predict_refined``), then
    ``nuscenes_metrics`` on the host. With ``timings``, the parts of
    ``nuscenes_detections`` and evaluate (the host's protocol)."""
    frames = nuscenes_detections(model, records, tta, refined, timings)
    laps = _Laps(timings, next(model.parameters()).device)
    stats = nuscenes_metrics(frames)
    laps.lap("evaluate")
    return stats


def _to_global(T: np.ndarray, xyz: np.ndarray, vel: np.ndarray):
    """(K, 3) lidar centres and (K, 2) lidar-frame velocities -> global BEV
    centres and velocities through ``global_from_lidar`` ``T``."""
    c = xyz @ T[:3, :3].T + T[:3, 3]
    return c[:, :2], vel @ T[:2, :2].T


def tracking_scenes(frames, timings: Optional[Dict[str, float]] = None):
    """``nuscenes_detections``' frames (records with tracking keys, else
    ValueError) -> (GT scenes, tracked scenes) as ``evaluate_tracking``
    takes them: frames grouped by scene in order of first appearance,
    sorted by timestamp within it, detections and GT moved to the global
    frame, the detections linked by ``track_sequence`` (the detector's
    vocabulary, DETECTION_CLASSES). With ``timings`` the seconds go under
    track."""
    t0 = time.perf_counter()
    if frames and "scene" not in frames[0][0]:
        raise ValueError("records lack tracking metadata (scene / timestamp "
                         "/ global_from_lidar / gt_track_ids)")
    scenes: Dict[bytes, list] = {}
    for ex, det in frames:
        T = np.asarray(ex["global_from_lidar"], np.float64)
        dc, dv = _to_global(T, det["boxes"][:, :3], det["boxes"][:, 6:8])
        gm = ex["gt_mask"]
        gb = ex["gt_boxes"][gm]
        gc, _ = _to_global(T, gb[:, :3], gb[:, 6:8])
        scenes.setdefault(bytes(ex["scene"]), []).append({
            "timestamp": float(ex["timestamp"]), "ego": T[:2, 3].copy(),
            "dt_centers": dc, "dt_vel": dv, "dt_classes": det["labels"],
            "dt_scores": det["scores"], "gt_centers": gc,
            "gt_classes": ex["gt_classes"][gm].astype(np.int64) - 1,
            "gt_ids": ex["gt_track_ids"][gm].astype(np.int64)})
    gt_scenes, dt_scenes = [], []
    for fs in scenes.values():
        fs.sort(key=lambda f: f["timestamp"])
        ids_per_frame = track_sequence(
            [{"centers": f["dt_centers"], "velocities": f["dt_vel"],
              "classes": f["dt_classes"], "scores": f["dt_scores"],
              "timestamp": f["timestamp"]} for f in fs],
            class_names=DETECTION_CLASSES)
        dt_scenes.append([
            {"centers": f["dt_centers"], "ids": ids,
             "classes": f["dt_classes"], "scores": f["dt_scores"],
             "ego": f["ego"]} for f, ids in zip(fs, ids_per_frame)])
        gt_scenes.append([
            {"centers": f["gt_centers"], "ids": f["gt_ids"],
             "classes": f["gt_classes"], "ego": f["ego"]} for f in fs])
    if timings is not None:
        timings["track"] = timings.get("track", 0.0) \
            + time.perf_counter() - t0
    return gt_scenes, dt_scenes


def nuscenes_tracking_evaluate(model: nn.Module, records,
                               timings: Optional[Dict[str, float]] = None
                               ) -> Dict[str, float]:
    """CenterPoint -> the greedy tracker -> the nuScenes tracking protocol
    (AMOTA, AMOTP, MOTA, IDS, per class AMOTA and AMOTP) over ``records``
    written with tracking metadata: ``nuscenes_detections`` on
    ``predict_from_points``, ``tracking_scenes``, ``evaluate_tracking``
    against ``gt_track_ids``.
    With ``timings``, the parts of ``nuscenes_detections``, track and
    evaluate."""
    frames = nuscenes_detections(model, records, timings=timings)
    gt_scenes, dt_scenes = tracking_scenes(frames, timings)
    t0 = time.perf_counter()
    stats = evaluate_tracking(gt_scenes, dt_scenes, DETECTION_CLASSES)
    if timings is not None:
        timings["evaluate"] = timings.get("evaluate", 0.0) \
            + time.perf_counter() - t0
    return stats


# Waymo: L1 / L2 AP and APH
WAYMO_EVAL_NAMES = ("Vehicle", "Pedestrian", "Cyclist")
WAYMO_EVAL_BATCH = 2
WAYMO_SCORE_THRESHOLD = 0.1  # detections kept for the protocol


def waymo_dataset(records) -> WaymoDetection:
    """``records`` itself where it is a dataset, else ``WaymoDetection`` of
    it (a shard pattern, a list of shard paths or records in memory)
    without augmentation."""
    if isinstance(records, (str, list, tuple)):
        return WaymoDetection(records, augment=False)
    return records


@torch.no_grad()
def waymo_annos(model: nn.Module, records, refined: bool = False,
                timings: Optional[Dict[str, float]] = None
                ) -> Tuple[List[Dict], List[Dict]]:
    """(GT annos, detection annos) of ``evaluate_waymo`` over ``records``
    (``waymo_dataset``), frame by frame: the GT straight from each record
    (7-wide z-bottom boxes, classes, lidar point counts); the detections of
    ``predict_from_points`` (``refined``: ``predict_refined`` of a
    two-stage model, else ValueError) on the model's device,
    WAYMO_EVAL_BATCH frames a call (the tail padded, ``_pad_batch``),
    those above WAYMO_SCORE_THRESHOLD turned back to 7-wide z-bottom boxes
    with 1-based classes. With ``timings`` the device is waited for between
    parts, and their seconds are added there: load (host examples), copy
    and predict (with the detections back on the host)."""
    ds = waymo_dataset(records)
    n = len(ds)
    if n == 0:
        raise ValueError("need at least one frame")
    method = nuscenes_route(model, refined=refined)
    dev = next(model.parameters()).device
    laps = _Laps(timings, dev)
    gt_annos, dt_annos = [], []
    for start in range(0, n, WAYMO_EVAL_BATCH):
        idxs = list(range(start, min(start + WAYMO_EVAL_BATCH, n)))
        exs = [ds[i] for i in idxs]
        pts = _pad_batch(np.stack([e["points"] for e in exs]),
                         WAYMO_EVAL_BATCH)
        msk = _pad_batch(np.stack([e["points_mask"] for e in exs]),
                         WAYMO_EVAL_BATCH)
        laps.lap("load")
        pts, msk = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
        laps.lap("copy")
        out = method(pts, msk)
        boxes = out["boxes"].double().cpu().numpy()
        scores = out["scores"].double().cpu().numpy()
        labels = out["labels"].long().cpu().numpy()
        laps.lap("predict")
        for bi, i in enumerate(idxs):
            rec = ds.records[i]
            g = np.asarray(rec["gt_boxes"], np.float64).reshape(-1, 7)
            gt_annos.append({
                "boxes": g,
                "classes": np.asarray(rec["gt_classes"], np.int32),
                "num_points": np.asarray(rec.get(
                    "num_points_in_gt", np.full(len(g), 100)))})
            keep = scores[bi] > WAYMO_SCORE_THRESHOLD
            b9 = boxes[bi][keep]
            b7 = np.concatenate([b9[:, :2], (b9[:, 2] - b9[:, 5] / 2)[:, None],
                                 b9[:, 3:6], b9[:, 8:9]], axis=1)
            dt_annos.append({"boxes": b7, "classes": labels[bi][keep] + 1,
                             "scores": scores[bi][keep]})
    return gt_annos, dt_annos


def waymo_evaluate(model: nn.Module, records, refined: bool = False,
                   timings: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Dict[str, float]]:
    """CenterPoint -> the Waymo protocol's L1 / L2 AP and APH per class of
    WAYMO_EVAL_NAMES over ``records``: ``waymo_annos`` on the route
    (``predict_from_points``; ``refined``: the two-stage
    ``predict_refined``), then ``evaluate_waymo`` without the range
    breakdowns, its IoUs on the model's device. With
    ``timings``, the parts of ``waymo_annos`` and evaluate (the protocol:
    the IoUs and the host's matching)."""
    gt_annos, dt_annos = waymo_annos(model, records, refined, timings)
    dev = next(model.parameters()).device
    laps = _Laps(timings, dev)
    table = evaluate_waymo(gt_annos, dt_annos, classes=WAYMO_EVAL_NAMES,
                           device=dev)
    laps.lap("evaluate")
    return table
