"""Waymo Open Dataset detection metrics: L1 / L2 AP and APH with range
breakdowns (counterpart of ``minddet_tpu/data/waymo_eval.py``:
``IOU_THRESHOLDS``, ``N_RECALL_PTS``, ``L2_MAX_POINTS``, ``RANGE_BUCKETS``,
``_heading_accuracy``, ``_match_frame``, ``_ap_from_matches``,
``_bev_range``, ``_eval_shard`` and ``evaluate_waymo``).

The protocol as the reference implements it, without the Waymo toolkit:

- matching: greedy by score against the same class's GT at 3D IoU
  {Vehicle 0.7, Pedestrian 0.5, Cyclist 0.5}; the IoU matrices come from
  ``ops/rotated_iou.py:rotated_iou_3d`` on ``device`` (one launch of the
  intersection kernel K4 on a CUDA device per frame, class, level and
  shard that has both detections and GT; none where either is empty);
- difficulty: LEVEL_2 is a GT labelled 2 or with at most L2_MAX_POINTS
  lidar points; L1 ignores LEVEL_2 GT (neither a miss nor, matched, a
  false positive), L2 scores every GT;
- APH: each true positive weighs its heading accuracy max(0, 1 - |dyaw| /
  pi) (the wrapped difference) in the TP mass of both precision and
  recall; the denominators stay counts;
- range breakdowns: GT and detections split by their own BEV centre
  distance into [0, 30), [30, 50), [50, inf), each shard scored alone;
- AP: the precision's monotone envelope sampled at N_RECALL_PTS recalls.

Boxes are (N, 7) [x, y, z_bottom, w, l, h, yaw] in the lidar frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from minddet_tpu_torch.ops.rotated_iou import rotated_iou_3d

IOU_THRESHOLDS = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5,
                  "Sign": 0.5}
N_RECALL_PTS = 101
L2_MAX_POINTS = 5
RANGE_BUCKETS = ((0.0, 30.0), (30.0, 50.0), (50.0, np.inf))


def _heading_accuracy(gt_yaw: float, dt_yaw: float) -> float:
    d = abs(gt_yaw - dt_yaw) % (2 * np.pi)
    d = min(d, 2 * np.pi - d)
    return max(0.0, 1.0 - d / np.pi)


def _match_frame(gt_boxes: np.ndarray, gt_ignore: np.ndarray,
                 dt_boxes: np.ndarray, dt_scores: np.ndarray,
                 iou_thr: float, device="cpu"):
    """Greedy matching of one frame's detections, best score first, each
    to the untaken GT of highest IoU if that reaches ``iou_thr`` ->
    per detection (score, flag 1 TP / 0 FP / -1 matched an ignored GT,
    heading weight of a TP). The IoUs are ``rotated_iou_3d`` in f32 on
    ``device``."""
    nd = len(dt_boxes)
    out_scores = dt_scores.copy()
    out_flag = np.zeros(nd, np.int32)
    out_hw = np.zeros(nd, np.float64)
    if nd == 0 or len(gt_boxes) == 0:  # nothing, or every detection a FP
        return out_scores, out_flag, out_hw
    iou = rotated_iou_3d(
        torch.from_numpy(np.asarray(dt_boxes, np.float32)).to(device),
        torch.from_numpy(np.asarray(gt_boxes, np.float32)).to(device)
    ).cpu().numpy()
    taken = np.zeros(len(gt_boxes), bool)
    for di in np.argsort(-dt_scores, kind="mergesort"):
        row = np.where(taken, -1.0, iou[di])
        gi = int(np.argmax(row))
        if row[gi] >= iou_thr:
            taken[gi] = True
            if gt_ignore[gi]:
                out_flag[di] = -1
            else:
                out_flag[di] = 1
                out_hw[di] = _heading_accuracy(float(gt_boxes[gi, 6]),
                                               float(dt_boxes[di, 6]))
    return out_scores, out_flag, out_hw


def _ap_from_matches(scores, flags, hws, n_gt: int, heading: bool) -> float:
    """AP (``heading`` False) or APH of the matched detections over
    ``n_gt`` GT: detections that matched an ignored GT are dropped."""
    keep = flags >= 0
    scores, flags, hws = scores[keep], flags[keep], hws[keep]
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    tp_w = np.where(flags[order] == 1, hws[order] if heading else 1.0, 0.0)
    fp = (flags[order] == 0).astype(np.float64)
    ctp_w = np.cumsum(tp_w)
    ctp_cnt = np.cumsum(flags[order] == 1)
    cfp = np.cumsum(fp)
    recall = ctp_w / n_gt
    precision = ctp_w / np.maximum(ctp_cnt + cfp, 1e-9)
    rec_grid = np.linspace(0, 1, N_RECALL_PTS)
    prec = np.interp(rec_grid, recall, precision, right=0.0)
    for i in range(len(prec) - 2, -1, -1):  # the monotone envelope
        prec[i] = max(prec[i], prec[i + 1])
    return float(np.mean(prec))


def _bev_range(boxes: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(boxes, np.float64).reshape(-1, 7)[:, :2],
                          axis=1)


def _eval_shard(gt_annos, dt_annos, cls, classes, thr,
                rng: Optional[Tuple[float, float]], device="cpu"
                ) -> Dict[str, float]:
    """AP_L1, APH_L1, AP_L2, APH_L2 (percent) of one class, over the
    objects whose BEV centre distance lies in ``rng`` (GT and detections
    each by their own; None: all)."""
    def cls_of(anno, i):
        c = anno["classes"][i]
        if isinstance(c, (str, np.str_)):
            return str(c)
        return classes[int(c) - 1] if 1 <= int(c) <= len(classes) else None

    per_level = {}
    for level in (1, 2):
        all_s, all_f, all_h = [], [], []
        n_gt = 0
        for g, d in zip(gt_annos, dt_annos):
            g_sel = [i for i in range(len(g["boxes"]))
                     if cls_of(g, i) == cls]
            gb = np.asarray(g["boxes"], np.float64).reshape(-1, 7)[g_sel]
            npts = np.asarray(g.get("num_points",
                                    np.full(len(g["boxes"]), 100)))[g_sel]
            diff = np.asarray(g.get("difficulty",
                                    np.ones(len(g["boxes"]))))[g_sel]
            d_sel = [i for i in range(len(d["boxes"]))
                     if cls_of(d, i) == cls]
            db = np.asarray(d["boxes"], np.float64).reshape(-1, 7)[d_sel]
            dsc = np.asarray(d["scores"], np.float64)[d_sel]
            if rng is not None:
                gk = (_bev_range(gb) >= rng[0]) & (_bev_range(gb) < rng[1])
                gb, npts, diff = gb[gk], npts[gk], diff[gk]
                dk = (_bev_range(db) >= rng[0]) & (_bev_range(db) < rng[1])
                db, dsc = db[dk], dsc[dk]
            is_l2 = (diff >= 2) | (npts <= L2_MAX_POINTS)
            ignore = is_l2 if level == 1 else np.zeros(len(gb), bool)
            n_gt += int((~ignore).sum())
            s, f, h = _match_frame(gb, ignore, db, dsc, thr, device)
            all_s.append(s)
            all_f.append(f)
            all_h.append(h)
        s = np.concatenate(all_s) if all_s else np.zeros(0)
        f = np.concatenate(all_f) if all_f else np.zeros(0, np.int32)
        h = np.concatenate(all_h) if all_h else np.zeros(0)
        per_level[f"AP_L{level}"] = 100 * _ap_from_matches(
            s, f, h, n_gt, heading=False)
        per_level[f"APH_L{level}"] = 100 * _ap_from_matches(
            s, f, h, n_gt, heading=True)
    return per_level


def evaluate_waymo(gt_annos: List[Dict], dt_annos: List[Dict],
                   classes: Sequence[str] = ("Vehicle", "Pedestrian",
                                             "Cyclist"),
                   range_breakdowns: bool = False, device="cpu"
                   ) -> Dict[str, Dict[str, float]]:
    """result[class] = {AP_L1, APH_L1, AP_L2, APH_L2} (percent), and with
    ``range_breakdowns`` the same four per RANGE_BUCKETS shard under
    "<metric>_[lo,hi)". Per frame the GT anno has boxes (N, 7), classes
    (names, or 1-based ids into ``classes``) and optionally num_points (N,)
    and difficulty (N,) (2 marks a labeller's LEVEL_2); the detection anno
    has boxes, classes and scores. The IoUs run on ``device``."""
    out: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        per_level = _eval_shard(gt_annos, dt_annos, cls, classes, thr, None,
                                device)
        if range_breakdowns:
            for lo, hi in RANGE_BUCKETS:
                tag = f"[{lo:g},{'inf' if np.isinf(hi) else f'{hi:g}'})"
                shard = _eval_shard(gt_annos, dt_annos, cls, classes, thr,
                                    (lo, hi), device)
                per_level.update({f"{k}_{tag}": v for k, v in shard.items()})
        out[cls] = per_level
    return out
