"""nuScenes detection metrics: mAP over centre-distance thresholds, the TP
errors and NDS (counterpart of ``minddet_tpu/data/nuscenes_eval.py``:
``filter_eval_boxes``, ``accumulate_class``, ``metric_data``, ``calc_ap``,
``calc_tp``, ``average_precision`` and ``evaluate_nuscenes``).

Host numpy, the official ``detection_cvpr_2019`` protocol as the devkit
computes it (without the devkit, which needs map data for one filter):

- GT and predictions are kept within each class's range of the ego
  position (``CLASS_RANGE``); GT boxes with no point are dropped where the
  sample gives point counts;
- per class, AP at centre distances {0.5, 1, 2, 4} m: precision on a
  101-point recall grid, its mean over ``prec[11:]`` after subtracting the
  minimum precision 0.1 and renormalizing;
- the TP errors (ATE, ASE, AOE, AVE, AAE) at 2 m: each error's cumulative
  mean in score order, read on the recall grid through the TPs'
  confidences and averaged from the minimum recall (exclusive) to the
  largest recall reached; the devkit's class exclusions (no attribute or
  velocity for barrier and traffic_cone, no orientation for traffic_cone,
  barrier's orientation modulo pi);
- NDS = (5 mAP + sum_k max(0, 1 - mTP_k)) / 10.

Equal scores are taken in the devkit's order: descending score, then
descending enumeration index (``np.lexsort`` with the index as the second
key). Boxes are [x, y, z, w, l, h, vx, vy, yaw]; attributes are ids into
``data/nuscenes.py:ATTRIBUTES`` (-1 void, left out of AAE).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_PTS = 101

# official detection_cvpr_2019 class_range (devkit config.json): max ego
# distance in meters per class, applied to GT and predictions alike
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}

# devkit per-class TP-metric exclusions (nuscenes/eval/detection/evaluate.py)
ATTR_EXCLUDED = frozenset({"barrier", "traffic_cone"})
VEL_EXCLUDED = frozenset({"barrier", "traffic_cone"})
ORIENT_EXCLUDED = frozenset({"traffic_cone"})
ORIENT_PERIOD_PI = frozenset({"barrier"})

TP_METRICS = ("ate", "ase", "aoe", "ave", "aae")


def _yaw_diff(a: np.ndarray, b: np.ndarray, period: float = 2 * np.pi) -> np.ndarray:
    d = (a - b) % period
    return np.minimum(d, period - d)


def _aligned_iou_1d(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Scale error: IoU of center- and yaw-aligned boxes (w, l, h)."""
    mins = np.minimum(d1, d2)
    maxs = np.maximum(d1, d2)
    inter = np.prod(mins, axis=-1)
    union = np.prod(d1, axis=-1) + np.prod(d2, axis=-1) - inter
    return inter / np.maximum(union, 1e-9)


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit utils.center_distance cummean: NaN-aware cumulative mean."""
    if len(x) and np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x.astype(np.float64))
    cnt = np.cumsum(~np.isnan(x))
    return np.divide(s, cnt, out=np.zeros_like(s), where=cnt != 0)


def filter_eval_boxes(
    gts: List[Dict], dts: List[Dict], cls: str,
    class_range: Optional[Dict[str, float]] = None,
) -> tuple:
    """devkit ``loaders.filter_eval_boxes``: keep boxes whose xy distance to
    the ego position (per-sample 'ego' (2,), default the frame origin) is
    strictly below ``class_range[cls]``; drop GT boxes with zero lidar+radar
    points when a per-box 'num_pts' array is present (predictions carry
    num_pts = -1 in the devkit, i.e. are never point-filtered)."""
    rng = (class_range or CLASS_RANGE).get(cls)
    if rng is None:
        return gts, dts

    def _filter(samples: List[Dict], is_gt: bool) -> List[Dict]:
        out = []
        for s in samples:
            boxes = np.asarray(s["boxes"], np.float64).reshape(-1, 9)
            ego = np.asarray(s.get("ego", (0.0, 0.0)), np.float64)
            keep = np.linalg.norm(boxes[:, :2] - ego[None, :2], axis=1) < rng
            if is_gt and "num_pts" in s:
                keep &= np.asarray(s["num_pts"]) != 0
            f = {"boxes": boxes[keep]}
            for k in ("scores", "attrs", "num_pts"):
                if k in s:
                    f[k] = np.asarray(s[k])[keep]
            out.append(f)
        return out

    return _filter(gts, True), _filter(dts, False)


def accumulate_class(
    gts: List[Dict], dts: List[Dict], dist_th: float, cls: str = ""
) -> Dict[str, np.ndarray]:
    """Match one class at one distance threshold across all samples
    (devkit ``algo.accumulate`` bookkeeping).

    gts/dts: per-sample dicts with 'boxes' (N, 9), dts also 'scores', both
    optionally 'attrs' (N,) int attribute ids (-1 = void). Returns per-
    prediction tp flags + scores sorted within each sample, per-TP errors
    (AAE entries are NaN for void GT attributes — the devkit's nan-aware
    cummean skips them) and the per-TP confidences the recall-grid
    interpolation needs."""
    period = np.pi if cls in ORIENT_PERIOD_PI else 2 * np.pi
    n_gt = sum(len(np.asarray(g["boxes"]).reshape(-1, 9)) for g in gts)
    all_scores, all_tp = [], []
    all_gidx: List[int] = []  # devkit global enumeration index (tie order)
    tp_conf: List[float] = []
    tp_gidx: List[int] = []
    errs = {k: [] for k in TP_METRICS}
    gbase = 0
    for g, d in zip(gts, dts):
        gb = np.asarray(g["boxes"], np.float64).reshape(-1, 9)
        db = np.asarray(d["boxes"], np.float64).reshape(-1, 9)
        ds = np.asarray(d["scores"], np.float64).reshape(-1)
        ga = np.asarray(g.get("attrs", np.full(len(gb), -1)), np.int64)
        da = np.asarray(d.get("attrs", np.full(len(db), -1)), np.int64)
        # devkit tie order: ``sorted((v, i) ...)[::-1]`` processes equal
        # scores by DESCENDING index (algo.py accumulate) — pinned by
        # test_nuscenes_eval_oracle.py fixture 3
        order = np.lexsort((np.arange(len(ds)), ds))[::-1]
        taken = np.zeros(len(gb), bool)
        for di in order:
            if len(gb) == 0:
                all_scores.append(ds[di])
                all_tp.append(False)
                all_gidx.append(gbase + di)
                continue
            dist = np.linalg.norm(gb[:, :2] - db[di, :2], axis=1)
            dist = np.where(taken, np.inf, dist)
            gi = int(np.argmin(dist))
            if dist[gi] < dist_th:
                taken[gi] = True
                all_scores.append(ds[di])
                all_tp.append(True)
                all_gidx.append(gbase + di)
                tp_conf.append(ds[di])
                tp_gidx.append(gbase + di)
                errs["ate"].append(dist[gi])
                errs["ase"].append(1.0 - _aligned_iou_1d(gb[gi, 3:6], db[di, 3:6]))
                errs["aoe"].append(_yaw_diff(gb[gi, 8], db[di, 8], period))
                errs["ave"].append(np.linalg.norm(gb[gi, 6:8] - db[di, 6:8]))
                # devkit attr_acc: NaN when the GT attribute is void
                errs["aae"].append(
                    (0.0 if da[di] == ga[gi] else 1.0) if ga[gi] >= 0
                    else np.nan)
            else:
                all_scores.append(ds[di])
                all_tp.append(False)
                all_gidx.append(gbase + di)
        gbase += len(ds)
    return {
        "scores": np.asarray(all_scores),
        "tp": np.asarray(all_tp, bool),
        "gidx": np.asarray(all_gidx, np.int64),
        "tp_conf": np.asarray(tp_conf),
        "tp_gidx": np.asarray(tp_gidx, np.int64),
        "n_gt": n_gt,
        "errors": {k: np.asarray(v) for k, v in errs.items()},
    }


def _no_predictions_md() -> Dict[str, np.ndarray]:
    """devkit DetectionMetricData.no_predictions(): AP 0, TP errors 1."""
    return {
        "precision": np.zeros(N_RECALL_PTS),
        "confidence": np.zeros(N_RECALL_PTS),
        **{k: np.ones(N_RECALL_PTS) for k in TP_METRICS},
    }


def metric_data(acc: Dict) -> Dict[str, np.ndarray]:
    """Per-(class, threshold) curves over the 101-point recall grid
    (devkit ``algo.accumulate`` postprocessing)."""
    if acc["n_gt"] == 0 or len(acc["scores"]) == 0 or len(acc["tp_conf"]) == 0:
        return _no_predictions_md()
    # devkit tie rule globally: descending (score, original enumeration
    # index) — carried through accumulate_class as ``gidx`` so cross- and
    # within-sample ties both order exactly like algo.py's one global sort
    order = np.lexsort((acc["gidx"], acc["scores"]))[::-1]
    tp = acc["tp"][order]
    conf = acc["scores"][order]
    tps = np.cumsum(tp).astype(np.float64)
    fps = np.cumsum(~tp).astype(np.float64)
    recall = tps / acc["n_gt"]
    precision = tps / (tps + fps)
    rec_interp = np.linspace(0, 1, N_RECALL_PTS)
    md = {
        "precision": np.interp(rec_interp, recall, precision, right=0),
        "confidence": np.interp(rec_interp, recall, conf, right=0),
    }
    # TP-error curves: cumulative mean over TPs in score order, sampled at
    # the recall grid's confidences (devkit: np.interp over reversed conf)
    tp_conf = acc["tp_conf"]
    tp_order = np.lexsort((acc["tp_gidx"], tp_conf))[::-1]
    tp_conf_sorted = tp_conf[tp_order]
    for k in TP_METRICS:
        e = acc["errors"][k][tp_order]
        cm = _cummean(e)
        md[k] = np.interp(
            md["confidence"][::-1], tp_conf_sorted[::-1], cm[::-1]
        )[::-1]
    return md


def calc_ap(md: Dict[str, np.ndarray]) -> float:
    """devkit calc_ap: mean precision over prec[11:] after the (0.1, 0.1)
    normalization — the min-recall bin itself is excluded."""
    prec = np.copy(md["precision"])
    prec = prec[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md: Dict[str, np.ndarray], metric: str) -> float:
    """devkit calc_tp: mean of the error curve between min-recall
    (exclusive) and the max achieved recall; 1.0 when never reached."""
    first_ind = round(100 * MIN_RECALL) + 1
    non_zero = np.nonzero(md["confidence"])[0]
    last_ind = int(non_zero[-1]) if len(non_zero) else 0
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric][first_ind: last_ind + 1]))


def average_precision(acc: Dict) -> float:
    """Official nuScenes AP for one accumulated (class, threshold)."""
    return calc_ap(metric_data(acc))


def evaluate_nuscenes(
    gt_by_class: Dict[str, List[Dict]],
    dt_by_class: Dict[str, List[Dict]],
    classes: Sequence[str],
    class_range: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """-> {'mAP', 'NDS', 'mATE', 'mASE', 'mAOE', 'mAVE', per-class APs}."""
    per_class_ap = {}
    tp_errs = {k: [] for k in TP_METRICS}
    excluded = {"aoe": ORIENT_EXCLUDED, "ave": VEL_EXCLUDED,
                "aae": ATTR_EXCLUDED}
    for cls in classes:
        gts, dts = filter_eval_boxes(
            gt_by_class.get(cls, []), dt_by_class.get(cls, []), cls,
            class_range)
        aps = []
        for th in DIST_THRESHOLDS:
            md = metric_data(accumulate_class(gts, dts, th, cls))
            aps.append(calc_ap(md))
            if th == TP_THRESHOLD:
                for k in tp_errs:
                    if cls in excluded.get(k, ()):  # devkit class exclusions
                        continue
                    tp_errs[k].append(calc_tp(md, k))
        per_class_ap[cls] = float(np.mean(aps))
    m_ap = float(np.mean(list(per_class_ap.values()))) if per_class_ap else 0.0
    m_tp = {
        f"m{k.upper()}": (float(np.mean(v)) if v else 1.0) for k, v in tp_errs.items()
    }
    # devkit nd_score: tp_scores clip 1 - mTP at 0, AOE in raw radians
    nds_terms = [max(0.0, 1.0 - m_tp[f"m{k.upper()}"]) for k in TP_METRICS]
    nds = (5.0 * m_ap + sum(nds_terms)) / 10.0
    out = {"mAP": m_ap, "NDS": nds, **m_tp}
    out.update({f"AP_{k}": v for k, v in per_class_ap.items()})
    return out
