"""nuScenes tracking metrics: AMOTA and AMOTP (counterpart of
``minddet_tpu/data/nuscenes_track_eval.py:evaluate_tracking``).

Host numpy, the ``tracking_nips_2019`` protocol from its published
definitions:

- the seven tracking classes (``track.NUSCENES_TRACKING_CLASSES``), GT and
  predictions kept within the detection protocol's class ranges of each
  frame's ego position (``nuscenes_eval.CLASS_RANGE``);
- per frame, CLEAR-MOT correspondence: pairs of the previous frame kept
  while their BEV centre distance stays within ``dist_th`` (2 m), the rest
  matched by Hungarian assignment on centre distance (scipy's
  ``linear_sum_assignment``, imported by the call); unmatched hypotheses
  are false positives, unmatched GT false negatives, and a GT whose
  hypothesis changes counts one id switch;
- AMOTA and AMOTP average the recall-normalized MOTA (MOTAR) and MOTP
  over ``n_thresholds`` recall levels in [min_recall, 1], each level's
  score threshold read from the sorted scores of the matched hypotheses:

      MOTAR(r) = max(0, 1 - (FP + FN + IDS - (1 - r) P) / (r P))

  with P the class's GT count; a level never reached counts MOTAR 0 and
  MOTP ``dist_th``.

Inputs are per-scene sequences of frames in a shared (global) frame:
``gt_scenes[s][f] = {"centers": (G, 2), "ids": (G,), "classes": (G,),
"ego": (2,)}`` and ``dt_scenes[s][f]`` the same with ``scores`` (D,);
``classes`` are ids into ``class_names``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from minddet_tpu_torch.data.nuscenes_eval import CLASS_RANGE
from minddet_tpu_torch.track import NUSCENES_TRACKING_CLASSES

DIST_TH = 2.0
N_THRESHOLDS = 40
MIN_RECALL = 0.1


def _class_scene(scene: List[Dict], cls_id: int, rng: Optional[float],
                 is_gt: bool) -> List[Dict]:
    """One class's boxes per frame, range-filtered around the frame ego."""
    out = []
    for fr in scene:
        centers = np.asarray(fr["centers"], np.float64).reshape(-1, 2)
        classes = np.asarray(fr["classes"], np.int64).reshape(-1)
        keep = classes == cls_id
        if rng is not None:
            if "ego" not in fr:
                # a silent (0, 0) default would range-drop every box of a
                # global-frame scene (real nuScenes coords sit hundreds of
                # meters from the map origin) and report a plausible 0.0
                raise ValueError(
                    "frame lacks 'ego' (BEV ego position) — required for "
                    "the per-class max-range filter; pass class_range={} "
                    "to disable filtering")
            ego = np.asarray(fr["ego"], np.float64)
            keep &= np.linalg.norm(centers - ego[None], axis=1) < rng
        sel = {"centers": centers[keep],
               "ids": np.asarray(fr["ids"], np.int64).reshape(-1)[keep]}
        if not is_gt:
            sel["scores"] = np.asarray(
                fr["scores"], np.float64).reshape(-1)[keep]
        out.append(sel)
    return out


def _mot_scene(
    gt_frames: List[Dict], dt_frames: List[Dict],
    dist_th: float, score_th: float,
) -> Dict[str, float]:
    """CLEAR-MOT accumulation over one scene for one class.

    Returns FP / FN / id-switch counts, match count and distance sum, and
    (for threshold selection) the scores of matched hypotheses.
    """
    from scipy.optimize import linear_sum_assignment

    last_hyp: Dict[int, int] = {}  # gt id -> most recent hypothesis id
    fp = fn = sw = n_match = 0
    sum_dist = 0.0
    match_scores: List[float] = []
    for g, d in zip(gt_frames, dt_frames):
        keep = d["scores"] >= score_th
        dc, dids, dsc = d["centers"][keep], d["ids"][keep], d["scores"][keep]
        gc, gids = g["centers"], g["ids"]
        G, D = len(gc), len(dc)
        if G == 0 and D == 0:
            continue
        dist = np.linalg.norm(gc[:, None, :] - dc[None, :, :], axis=-1) \
            if G and D else np.zeros((G, D))
        pairs = []
        g_free = np.ones(G, bool)
        d_free = np.ones(D, bool)
        # step 1 (CLEAR-MOT): keep surviving correspondences
        hyp_col = {int(h): j for j, h in enumerate(dids)}
        for gi in range(G):
            h = last_hyp.get(int(gids[gi]))
            dj = hyp_col.get(h) if h is not None else None
            if dj is not None and d_free[dj] and dist[gi, dj] <= dist_th:
                pairs.append((gi, dj))
                g_free[gi] = d_free[dj] = False
        # step 2: Hungarian over the rest (distances above the gate are
        # forbidden via a large finite cost, then filtered)
        gi_rest = np.nonzero(g_free)[0]
        dj_rest = np.nonzero(d_free)[0]
        if len(gi_rest) and len(dj_rest):
            sub = dist[np.ix_(gi_rest, dj_rest)]
            cost = np.where(sub <= dist_th, sub, 1e9)
            rr, cc = linear_sum_assignment(cost)
            for a, b in zip(rr, cc):
                if sub[a, b] <= dist_th:
                    pairs.append((int(gi_rest[a]), int(dj_rest[b])))
        for gi, dj in pairs:
            gid, hid = int(gids[gi]), int(dids[dj])
            if gid in last_hyp and last_hyp[gid] != hid:
                sw += 1
            last_hyp[gid] = hid
            n_match += 1
            sum_dist += float(dist[gi, dj])
            match_scores.append(float(dsc[dj]))
        fp += D - len(pairs)
        fn += G - len(pairs)
    return {"fp": fp, "fn": fn, "sw": sw, "n_match": n_match,
            "sum_dist": sum_dist, "match_scores": match_scores}


def _accumulate_class(
    gt_scenes: List[List[Dict]], dt_scenes: List[List[Dict]],
    dist_th: float, score_th: float,
) -> Dict[str, float]:
    tot = {"fp": 0, "fn": 0, "sw": 0, "n_match": 0, "sum_dist": 0.0,
           "match_scores": []}
    for g, d in zip(gt_scenes, dt_scenes):
        r = _mot_scene(g, d, dist_th, score_th)
        for k in ("fp", "fn", "sw", "n_match"):
            tot[k] += r[k]
        tot["sum_dist"] += r["sum_dist"]
        tot["match_scores"].extend(r["match_scores"])
    return tot


def evaluate_tracking(
    gt_scenes: List[List[Dict]],
    dt_scenes: List[List[Dict]],
    class_names: Sequence[str],
    tracking_classes: Sequence[str] = NUSCENES_TRACKING_CLASSES,
    dist_th: float = DIST_TH,
    n_thresholds: int = N_THRESHOLDS,
    min_recall: float = MIN_RECALL,
    class_range: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """-> {'AMOTA', 'AMOTP', 'MOTA', 'IDS', per-class AMOTA/AMOTP}.

    'MOTA' / 'IDS' report the unthresholded (all predictions) pass — the
    plain CLEAR-MOT operating point — while AMOTA/AMOTP integrate over the
    recall sweep as defined above.
    """
    if len(gt_scenes) != len(dt_scenes):
        raise ValueError(
            f"{len(gt_scenes)} GT scenes vs {len(dt_scenes)} DT scenes")
    for si, (g, d) in enumerate(zip(gt_scenes, dt_scenes)):
        if len(g) != len(d):
            # zip would silently truncate: trailing GT would never count FN,
            # trailing detections never FP — inflated metrics
            raise ValueError(
                f"scene {si}: {len(g)} GT frames vs {len(d)} DT frames")
    ranges = CLASS_RANGE if class_range is None else class_range
    per_amota, per_amotp, per_mota, total_sw = {}, {}, {}, 0
    rec_levels = np.linspace(min_recall, 1.0, n_thresholds)
    for cls in tracking_classes:
        if cls not in class_names:
            continue
        cid = list(class_names).index(cls)
        rng = ranges.get(cls)
        g_sc = [_class_scene(s, cid, rng, True) for s in gt_scenes]
        d_sc = [_class_scene(s, cid, rng, False) for s in dt_scenes]
        n_gt = sum(len(fr["ids"]) for s in g_sc for fr in s)
        if n_gt == 0:
            continue
        base = _accumulate_class(g_sc, d_sc, dist_th, -np.inf)
        per_mota[cls] = max(
            0.0, 1.0 - (base["fp"] + base["fn"] + base["sw"]) / n_gt)
        total_sw += base["sw"]
        scores = np.sort(np.asarray(base["match_scores"]))[::-1]
        motar, motp = [], []
        acc_by_th: Dict[float, Dict[str, float]] = {}
        for r in rec_levels:
            k = int(np.ceil(r * n_gt))  # matches needed for recall r
            if k <= 0 or k > len(scores):
                motar.append(0.0)
                motp.append(dist_th)
                continue
            th = float(scores[k - 1])
            # adjacent recall levels often share a threshold (score ties);
            # the CLEAR-MOT accumulation is the expensive part — memoize it
            acc = acc_by_th.get(th)
            if acc is None:
                acc = acc_by_th[th] = _accumulate_class(
                    g_sc, d_sc, dist_th, th)
            rec = acc["n_match"] / n_gt
            if rec <= 0:
                motar.append(0.0)
                motp.append(dist_th)
                continue
            motar.append(max(0.0, 1.0 - (
                acc["fp"] + acc["fn"] + acc["sw"] - (1.0 - rec) * n_gt
            ) / (rec * n_gt)))
            motp.append(acc["sum_dist"] / max(acc["n_match"], 1))
        per_amota[cls] = float(np.mean(motar))
        per_amotp[cls] = float(np.mean(motp))
    out = {
        "AMOTA": float(np.mean(list(per_amota.values()))) if per_amota else 0.0,
        "AMOTP": float(np.mean(list(per_amotp.values()))) if per_amotp else dist_th,
        "MOTA": float(np.mean(list(per_mota.values()))) if per_mota else 0.0,
        "IDS": total_sw,
    }
    out.update({f"AMOTA_{k}": v for k, v in per_amota.items()})
    out.update({f"AMOTP_{k}": v for k, v in per_amotp.items()})
    return out
