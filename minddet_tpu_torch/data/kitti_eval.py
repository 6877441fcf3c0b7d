"""The official KITTI AP evaluator: bbox, BEV, 3D and AOS (counterpart of
``minddet_tpu/data/kitti_eval.py``: ``clean_gt``, ``clean_dt``,
``_metric_boxes``, ``calculate_overlaps``, ``_dc_iod_max``,
``_image_statistics_batch``, ``_image_statistics``,
``_threshold_phase_scores``, ``_ap_thresholds``, ``eval_class`` and
``get_official_eval_result``).

The AP bookkeeping (difficulty filtering, don't-care regions, the greedy
matcher over all 41 score thresholds at once, 41-point interpolation) is
the reference's numpy on the host. The overlap matrices are computed once
per metric for the whole dataset on ``device``, one batched call per chunk
of 256 images padded with zero boxes to the chunk's largest counts: the
image boxes' IoU (``ops/box.py:pairwise_iou``), and the camera-frame BEV
and 3D IoUs (``ops/rotated_iou.py:rotated_iou_bev`` and
``rotated_iou_3d``), which launch the rotated-box intersection kernel (K4)
once per chunk on a CUDA device and run its plain version on the CPU.

Camera-frame conventions: location (x, y, z) with y down, dimensions (l,
h, w), rotation_y about the camera y axis; BEV boxes lie in the (x, z)
plane.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from minddet_tpu_torch.ops.box import pairwise_iou
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_3d, rotated_iou_bev

N_SAMPLE_PTS = 41
CHUNK = 256  # images per overlap call

# difficulty -> (min bbox height px, max occlusion, max truncation)
DIFFICULTY_RULES = {
    0: (40.0, 0, 0.15),
    1: (25.0, 1, 0.30),
    2: (25.0, 2, 0.50),
}

# class -> the class counted as "similar" (ignored, not a false positive)
SIMILAR_CLASSES = {"Car": "Van", "Pedestrian": "Person_sitting"}

DEFAULT_MIN_OVERLAPS = {  # (bbox, bev, 3d)
    "Car": (0.7, 0.7, 0.7),
    "Pedestrian": (0.5, 0.5, 0.5),
    "Cyclist": (0.5, 0.5, 0.5),
    "Van": (0.7, 0.7, 0.7),
    "Truck": (0.7, 0.7, 0.7),
}


def clean_gt(anno: Dict, current_class: str, difficulty: int):
    """Per-image GT filtering -> (ignored, don't-care boxes, counted):
    ignored 0 counted, 1 ignored (the similar class, or harder than the
    difficulty; the height cut is inclusive), -1 another class."""
    min_h, max_occ, max_trunc = DIFFICULTY_RULES[difficulty]
    names = np.asarray(anno["name"])
    n = len(names)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros((0, 4)), 0
    ignored = np.full(n, -1, np.int32)
    is_cls = names == current_class
    heights = anno["bbox"][:, 3] - anno["bbox"][:, 1]
    too_hard = ((np.asarray(anno["occluded"]) > max_occ)
                | (np.asarray(anno["truncated"]) > max_trunc)
                | (heights <= min_h))
    ignored[is_cls & too_hard] = 1
    ignored[is_cls & ~too_hard] = 0
    similar = SIMILAR_CLASSES.get(current_class)
    if similar is not None:
        ignored[names == similar] = 1
    dc = anno["bbox"][names == "DontCare"]
    return ignored, dc, int(np.sum(ignored == 0))


def clean_dt(anno: Dict, current_class: str, difficulty: int):
    """Per-image DT filtering: -1 another class, 1 too small for the
    difficulty (strict cut), 0 counted."""
    min_h = DIFFICULTY_RULES[difficulty][0]
    names = np.asarray(anno["name"])
    n = len(names)
    if n == 0:
        return np.zeros(0, np.int32)
    ignored = np.full(n, -1, np.int32)
    is_cls = names == current_class
    heights = anno["bbox"][:, 3] - anno["bbox"][:, 1]
    ignored[is_cls & (heights < min_h)] = 1
    ignored[is_cls & (heights >= min_h)] = 0
    return ignored


def _metric_boxes(anno: Dict, metric: str) -> np.ndarray:
    """An image's boxes in the layout the metric's IoU takes: bbox (N, 4);
    bev [x, z, l, w, -ry]; 3d [x, z, -y, l, w, h, -ry] (z the bottom)."""
    if metric == "bbox":
        return np.asarray(anno["bbox"], np.float32).reshape(-1, 4)
    loc = np.asarray(anno["location"], np.float32).reshape(-1, 3)
    dim = np.asarray(anno["dimensions"], np.float32).reshape(-1, 3)
    rot = np.asarray(anno["rotation_y"], np.float32).reshape(-1)
    if metric == "bev":
        return np.stack([loc[:, 0], loc[:, 2], dim[:, 0], dim[:, 2], -rot],
                        -1)
    if metric == "3d":
        return np.stack([loc[:, 0], loc[:, 2], -loc[:, 1], dim[:, 0],
                         dim[:, 2], dim[:, 1], -rot], -1)
    raise ValueError(metric)


_IOU_FNS = {"bbox": pairwise_iou, "bev": rotated_iou_bev, "3d": rotated_iou_3d}


def calculate_overlaps(gt_annos: List[Dict], dt_annos: List[Dict],
                       metric: str, chunk: int = CHUNK, device="cpu"
                       ) -> List[np.ndarray]:
    """(num_gt, num_dt) f32 overlaps per image for the whole dataset: per
    chunk of ``chunk`` images one batched call on ``device`` over the
    images' boxes zero-padded to the chunk's largest counts (a chunk whose
    images have no GT or no detection at all gives zeros)."""
    fn = _IOU_FNS[metric]
    boxes_g = [_metric_boxes(g, metric) for g in gt_annos]
    boxes_d = [_metric_boxes(d, metric) for d in dt_annos]
    out: List[np.ndarray] = []
    for s in range(0, len(boxes_g), chunk):
        gs, ds = boxes_g[s:s + chunk], boxes_d[s:s + chunk]
        mg = max((len(b) for b in gs), default=0)
        md = max((len(b) for b in ds), default=0)
        if mg == 0 or md == 0:
            out.extend(np.zeros((len(b), len(d)), np.float32)
                       for b, d in zip(gs, ds))
            continue
        wid = gs[0].shape[1] if len(gs[0].shape) > 1 else 4
        gp = np.zeros((len(gs), mg, wid), np.float32)
        dp = np.zeros((len(ds), md, wid), np.float32)
        for i, b in enumerate(gs):
            gp[i, :len(b)] = b
        for i, b in enumerate(ds):
            dp[i, :len(b)] = b
        ious = fn(torch.from_numpy(gp).to(device),
                  torch.from_numpy(dp).to(device)).cpu().numpy()
        out.extend(ious[i, :len(gs[i]), :len(ds[i])] for i in range(len(gs)))
    return out


def _dc_iod_max(dt_bbox: np.ndarray, dc_boxes: np.ndarray) -> np.ndarray:
    """Each detection's largest intersection over its own area with any
    don't-care region, (nd,)."""
    dtb = np.asarray(dt_bbox, np.float32)
    dcb = np.asarray(dc_boxes, np.float32).reshape(-1, 4)
    lt = np.maximum(dtb[:, None, :2], dcb[None, :, :2])
    rb = np.minimum(dtb[:, None, 2:], dcb[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = (dtb[:, 2] - dtb[:, 0]) * (dtb[:, 3] - dtb[:, 1])
    iod = inter / np.maximum(area[:, None], np.float32(1e-8))
    return iod.max(axis=1, initial=0.0)


def _image_statistics_batch(overlaps, gt, dt, ignored_gt, ignored_dt,
                            dc_boxes, min_overlap, thresholds: np.ndarray,
                            compute_aos: bool = False):
    """tp, fp, fn (T,), the AOS similarity (T,; -1 where a threshold has no
    TP) and the matched scores per threshold, for one image at all
    ``thresholds`` at once. Greedy and GT-centric: per counted GT the
    best-overlap counted detection over ``min_overlap`` (strictly) wins, an
    ignored detection is a fallback that neutralizes the GT, ties go to the
    lowest index; a false positive mostly inside a don't-care region is
    not counted."""
    thresholds = np.asarray(thresholds, np.float64)
    nd = len(dt["name"])
    ng = len(gt["name"])
    T = len(thresholds)
    scores = np.asarray(dt["score"], np.float64).reshape(-1)
    score_ok = scores[None, :] >= thresholds[:, None]
    assigned = np.zeros((T, nd), bool)
    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T, np.float64)
    collect_scores = T == 1
    matched_scores: List[List[float]] = [[] for _ in range(T)]
    valid_dt = ignored_dt == 0
    ign_dt = ignored_dt == 1
    t_idx = np.arange(T)
    gt_alpha = np.asarray(gt.get("alpha", np.zeros(ng)))
    dt_alpha = np.asarray(dt.get("alpha", np.zeros(nd)))
    for i in range(ng):
        if ignored_gt[i] == -1 or nd == 0:
            if ignored_gt[i] == 0:
                fn += 1
            continue
        ov_ok = overlaps[i] > min_overlap
        base = score_ok & ~assigned & ov_ok[None, :]
        cand_v = base & valid_dt[None, :]
        cand_i = base & ign_dt[None, :]
        has_v = cand_v.any(axis=1)
        best_v = np.argmax(np.where(cand_v, overlaps[i][None, :], -np.inf),
                           axis=1)
        has_i = cand_i.any(axis=1)
        first_i = np.argmax(cand_i, axis=1)
        det = np.where(has_v, best_v, np.where(has_i, first_i, -1))
        matched = det >= 0
        is_tp = has_v & (ignored_gt[i] == 0)
        fn += (~matched) & (ignored_gt[i] == 0)
        tp += is_tp
        if compute_aos:
            delta = gt_alpha[i] - dt_alpha[np.clip(det, 0, nd - 1)]
            sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
        if collect_scores:
            for t in np.nonzero(is_tp)[0]:
                matched_scores[t].append(scores[det[t]])
        assigned[t_idx[matched], det[matched]] = True

    fp_mask = (~assigned) & valid_dt[None, :] & score_ok
    fp = fp_mask.sum(axis=1)
    if len(dc_boxes) and nd:
        iod_max = _dc_iod_max(dt["bbox"], dc_boxes)
        fp -= (fp_mask & (iod_max > min_overlap)[None, :]).sum(axis=1)
    similarity = np.where(compute_aos & (tp > 0), sim, -1.0)
    return tp, fp, fn, similarity, matched_scores


def _image_statistics(overlaps, gt, dt, ignored_gt, ignored_dt, dc_boxes,
                      min_overlap, threshold, compute_aos=False):
    """``_image_statistics_batch`` at one threshold: (tp, fp, fn,
    similarity, matched scores)."""
    tp, fp, fn, sim, scores = _image_statistics_batch(
        overlaps, gt, dt, ignored_gt, ignored_dt, dc_boxes, min_overlap,
        np.asarray([threshold]), compute_aos)
    return int(tp[0]), int(fp[0]), int(fn[0]), float(sim[0]), scores[0]


def _threshold_phase_scores(overlaps, gt, dt, ignored_gt, ignored_dt,
                            min_overlap) -> List[float]:
    """The matched TP scores of the threshold-collection phase: per GT the
    unassigned candidate over ``min_overlap`` with the best score (the
    first index among ties); an ignored detection is a candidate that
    neutralizes its GT without giving a score."""
    nd = len(dt["name"])
    scores = np.asarray(dt["score"], np.float64).reshape(-1)
    assigned = np.zeros(nd, bool)
    not_excluded = np.asarray(ignored_dt) != -1
    out: List[float] = []
    for i in range(len(gt["name"])):
        if ignored_gt[i] == -1 or nd == 0:
            continue
        cand = (~assigned) & not_excluded & (overlaps[i] > min_overlap)
        if not cand.any():
            continue
        j = int(np.argmax(np.where(cand, scores, -np.inf)))
        assigned[j] = True
        if ignored_gt[i] == 0 and ignored_dt[j] == 0:
            out.append(float(scores[j]))
    return out


def _ap_thresholds(scores: np.ndarray, num_gt: int) -> np.ndarray:
    """The 41 recall-sample score thresholds (the official
    ``get_thresholds``)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
                i < len(scores) - 1):
            continue
        thresholds.append(s)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return np.asarray(thresholds)


def eval_class(gt_annos: List[Dict], dt_annos: List[Dict],
               current_class: str, difficulty: int, metric: str,
               min_overlap: float, compute_aos: bool = False,
               overlaps: Optional[List[np.ndarray]] = None, device="cpu"):
    """AP (and AOS) of one (class, difficulty, metric), 11 of the 41
    recall points: {ap, aos, recall, precision}. ``overlaps`` (from
    ``calculate_overlaps``) are computed on ``device`` where not given."""
    assert len(gt_annos) == len(dt_annos)
    if overlaps is None:
        overlaps = calculate_overlaps(gt_annos, dt_annos, metric,
                                      device=device)
    per_image = []
    total_valid_gt = 0
    for ov, gt, dt in zip(overlaps, gt_annos, dt_annos):
        ignored_gt, dc, num_valid = clean_gt(gt, current_class, difficulty)
        ignored_dt = clean_dt(dt, current_class, difficulty)
        per_image.append((ov, gt, dt, ignored_gt, ignored_dt, dc))
        total_valid_gt += num_valid
    if total_valid_gt == 0:
        return {"ap": 0.0, "aos": 0.0, "recall": np.zeros(0),
                "precision": np.zeros(0)}

    all_scores = []
    for ov, gt, dt, ig, idt, dc in per_image:
        all_scores.extend(
            _threshold_phase_scores(ov, gt, dt, ig, idt, min_overlap))
    thresholds = _ap_thresholds(np.asarray(all_scores), total_valid_gt)

    pr = np.zeros((len(thresholds), 4))  # tp, fp, fn, similarity
    for ov, gt, dt, ig, idt, dc in per_image:
        tp, fp, fn, sim, _ = _image_statistics_batch(
            ov, gt, dt, ig, idt, dc, min_overlap, thresholds, compute_aos)
        pr[:, 0] += tp
        pr[:, 1] += fp
        pr[:, 2] += fn
        pr[:, 3] += np.where(sim != -1, sim, 0.0)

    precision = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
    recall = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 2], 1e-9)
    aos = pr[:, 3] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
    prec_i = np.zeros(N_SAMPLE_PTS)
    aos_i = np.zeros(N_SAMPLE_PTS)
    prec_i[:len(precision)] = precision
    aos_i[:len(aos)] = aos
    for i in range(len(prec_i) - 2, -1, -1):
        prec_i[i] = max(prec_i[i], prec_i[i + 1])
        aos_i[i] = max(aos_i[i], aos_i[i + 1])
    ap = float(np.mean(prec_i[0::4]) * 100)
    ap_aos = float(np.mean(aos_i[0::4]) * 100)
    return {"ap": ap, "aos": ap_aos, "recall": recall, "precision": precision}


def get_official_eval_result(gt_annos: List[Dict], dt_annos: List[Dict],
                             classes: Sequence[str] = ("Car",),
                             metrics: Sequence[str] = ("bbox", "bev", "3d"),
                             compute_aos: bool = False, device="cpu",
                             timings: Optional[Dict[str, float]] = None
                             ) -> Dict[str, Dict[str, List[float]]]:
    """The AP table, result[class][metric] = [easy, moderate, hard] (and
    result[class]["aos"] with ``compute_aos``) at DEFAULT_MIN_OVERLAPS.
    Each metric's overlaps are computed once on ``device`` and shared by
    every class and difficulty. With ``timings`` the seconds of the
    overlaps and of the host's bookkeeping are added there under
    "overlaps" and "evaluate"."""
    t0 = time.perf_counter()
    metric_idx = {"bbox": 0, "bev": 1, "3d": 2}
    need = list(metrics)
    if compute_aos and "bbox" not in need:
        need.append("bbox")
    shared = {m: calculate_overlaps(gt_annos, dt_annos, m, device=device)
              for m in need}
    t1 = time.perf_counter()
    out: Dict[str, Dict[str, List[float]]] = {}
    for cls in classes:
        out[cls] = {}
        for metric in metrics:
            mo = DEFAULT_MIN_OVERLAPS[cls][metric_idx[metric]]
            out[cls][metric] = [
                eval_class(gt_annos, dt_annos, cls, diff, metric, mo,
                           compute_aos=compute_aos and metric == "bbox",
                           overlaps=shared[metric])["ap"]
                for diff in (0, 1, 2)]
        if compute_aos:
            out[cls]["aos"] = [
                eval_class(gt_annos, dt_annos, cls, d, "bbox",
                           DEFAULT_MIN_OVERLAPS[cls][0], True,
                           overlaps=shared["bbox"])["aos"]
                for d in (0, 1, 2)]
    if timings is not None:
        timings["overlaps"] = timings.get("overlaps", 0.0) + t1 - t0
        timings["evaluate"] = (timings.get("evaluate", 0.0)
                               + time.perf_counter() - t1)
    return out
