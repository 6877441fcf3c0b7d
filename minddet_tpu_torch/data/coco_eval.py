"""COCO-protocol detection evaluator (mAP / AR), pycocotools-compatible
math (counterpart of ``minddet_tpu/data/coco_eval.py``, a numpy copy of it:
``_iou_with_crowd``, ``_mask_iou_with_crowd``, ``_evaluate_img`` and
``COCOEvaluator``).

The COCO bbox (and segm) evaluation protocol without pycocotools: 10 IoU
thresholds (.50:.05:.95), 101 recall points, area ranges, maxDets,
crowd-ignore handling, right-max precision interpolation, the standard
12-number summary. Boxes are [x1, y1, x2, y2] absolute pixels. Host numpy
only: it runs after the device has produced the detections.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_with_crowd(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; for crowd GT the denominator is the detection area only."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _mask_iou_with_crowd(
    dt_masks: np.ndarray, gt_masks: np.ndarray, iscrowd: np.ndarray
) -> np.ndarray:
    """(D, G) mask IoU (pycocotools segm mode); crowd denominator = dt area."""
    if len(dt_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(dt_masks), len(gt_masks)))
    d = dt_masks.reshape(len(dt_masks), -1).astype(np.float64)
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float64)
    inter = d @ g.T
    area_d = d.sum(1)
    area_g = g.sum(1)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _evaluate_img(dts, gts, area_rng, max_det):
    """Per-(image, category) matching at all IoU thresholds.

    dts: dict(boxes (D,4), scores (D,), optional masks (D,H,W));
    gts: dict(boxes (G,4), iscrowd (G,), optional masks (G,H,W)).
    With masks present (segm mode) IoU and areas come from the masks.
    Returns dt_matches (T, D'), dt_ignore (T, D'), dt_scores (D'),
    gt_ignore (G,), num_nonignored_gt.
    """
    g_boxes = gts["boxes"]
    segm = gts.get("masks") is not None
    crowd = gts["iscrowd"].astype(bool)
    if segm and len(g_boxes):
        g_area = gts["masks"].reshape(len(g_boxes), -1).sum(1).astype(np.float64)
    elif segm:
        g_area = np.zeros(0)
    else:
        g_area = (
            (g_boxes[:, 2] - g_boxes[:, 0]) * (g_boxes[:, 3] - g_boxes[:, 1])
            if len(g_boxes) else np.zeros(0)
        )
    gt_ig = crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])

    # sort GT: non-ignored first (pycocotools gtind ordering)
    g_ord = np.argsort(gt_ig, kind="mergesort")
    g_boxes = g_boxes[g_ord]
    gt_ig = gt_ig[g_ord]
    crowd = crowd[g_ord]

    d_ord = np.argsort(-dts["scores"], kind="mergesort")[:max_det]
    d_boxes = dts["boxes"][d_ord]
    d_scores = dts["scores"][d_ord]

    if segm:
        ious = _mask_iou_with_crowd(
            dts["masks"][d_ord], gts["masks"][g_ord], crowd
        )
    else:
        ious = _iou_with_crowd(d_boxes, g_boxes, crowd)
    t_n = len(IOU_THRS)
    d_n, g_n = len(d_boxes), len(g_boxes)
    dt_m = np.zeros((t_n, d_n), np.int64) - 1  # matched gt index or -1
    gt_m = np.zeros((t_n, g_n), np.int64) - 1
    dt_ig = np.zeros((t_n, d_n), bool)

    for ti, thr in enumerate(IOU_THRS):
        for di in range(d_n):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                if gt_m[ti, gi] >= 0 and not crowd[gi]:
                    continue
                # stop at ignored gt if a real match was already found
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = gt_ig[m]
            dt_m[ti, di] = m
            gt_m[ti, m] = di

    # detections outside the area range that matched nothing are ignored
    if segm and d_n:
        d_area = dts["masks"][d_ord].reshape(d_n, -1).sum(1).astype(np.float64)
    elif d_n:
        d_area = (d_boxes[:, 2] - d_boxes[:, 0]) * (d_boxes[:, 3] - d_boxes[:, 1])
    else:
        d_area = np.zeros(0)
    out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
    dt_ig = dt_ig | ((dt_m == -1) & out_of_rng[None, :])
    return dt_m >= 0, dt_ig, d_scores, int(np.sum(~gt_ig))


class COCOEvaluator:
    """Accumulate per-image results and produce the 12 COCO summary metrics.

    Usage::

        ev = COCOEvaluator(num_classes)
        for image_id: ev.add(image_id, class_id, dt_boxes, dt_scores, gt_boxes, gt_iscrowd)
        stats = ev.summarize()   # {'AP': .., 'AP50': .., ...}
    """

    def __init__(self, class_ids: Sequence[int]):
        self.class_ids = list(class_ids)
        # per (class) lists of per-image payloads
        self._store: Dict[int, List] = {c: [] for c in self.class_ids}

    def add(
        self,
        class_id: int,
        dt_boxes: np.ndarray,
        dt_scores: np.ndarray,
        gt_boxes: np.ndarray,
        gt_iscrowd: Optional[np.ndarray] = None,
        dt_masks: Optional[np.ndarray] = None,
        gt_masks: Optional[np.ndarray] = None,
    ) -> None:
        """Pass ``dt_masks``/``gt_masks`` (N, H, W) bool for segm-mode (mask
        AP) evaluation — IoU and area filtering then use the bitmaps, the
        pycocotools ``iouType='segm'`` protocol Mask R-CNN needs."""
        if gt_iscrowd is None:
            gt_iscrowd = np.zeros(len(gt_boxes), bool)
        self._store[class_id].append(
            (
                {"boxes": np.asarray(dt_boxes, np.float64).reshape(-1, 4),
                 "scores": np.asarray(dt_scores, np.float64).reshape(-1),
                 "masks": (np.asarray(dt_masks, bool)
                           if dt_masks is not None else None)},
                {"boxes": np.asarray(gt_boxes, np.float64).reshape(-1, 4),
                 "iscrowd": np.asarray(gt_iscrowd, bool).reshape(-1),
                 "masks": (np.asarray(gt_masks, bool)
                           if gt_masks is not None else None)},
            )
        )

    def _accumulate(self, area: str, max_det: int) -> np.ndarray:
        """precision (T, R, K) over IoU thresholds, recall points, classes."""
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        k_n = len(self.class_ids)
        precision = -np.ones((t_n, r_n, k_n))
        recall = -np.ones((t_n, k_n))
        rng = AREA_RANGES[area]
        for ki, cid in enumerate(self.class_ids):
            matches, ignores, scores, n_gt = [], [], [], 0
            for dts, gts in self._store[cid]:
                m, ig, sc, ng = _evaluate_img(dts, gts, rng, max_det)
                matches.append(m)
                ignores.append(ig)
                scores.append(sc)
                n_gt += ng
            if n_gt == 0:
                continue
            scores = np.concatenate(scores)
            order = np.argsort(-scores, kind="mergesort")
            m = np.concatenate(matches, axis=1)[:, order]
            ig = np.concatenate(ignores, axis=1)[:, order]

            tps = np.cumsum(m & ~ig, axis=1).astype(np.float64)
            fps = np.cumsum(~m & ~ig, axis=1).astype(np.float64)
            for ti in range(t_n):
                tp, fp = tps[ti], fps[ti]
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, 1e-9)
                recall[ti, ki] = rc[-1] if len(rc) else 0.0
                # right-max interpolation
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(r_n)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ki] = q
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        def _ap(precision, iou_thr=None):
            p = precision
            if iou_thr is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                p = p[ti : ti + 1]
            valid = p[p > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        def _ar(recall):
            valid = recall[recall > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        p_all, r_all = self._accumulate("all", 100)
        stats = {
            "AP": _ap(p_all),
            "AP50": _ap(p_all, 0.5),
            "AP75": _ap(p_all, 0.75),
        }
        for area in ("small", "medium", "large"):
            p, _ = self._accumulate(area, 100)
            stats[f"AP_{area}"] = _ap(p)
        for md in MAX_DETS:
            _, r = self._accumulate("all", md)
            stats[f"AR@{md}"] = _ar(r)
        for area in ("small", "medium", "large"):
            _, r = self._accumulate(area, 100)
            stats[f"AR_{area}"] = _ar(r)
        return stats
