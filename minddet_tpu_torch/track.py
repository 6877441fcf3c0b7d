"""A greedy multi-object tracker over per-frame detections, CenterPoint's
(counterpart of ``minddet_tpu/track.py``: ``GreedyTracker`` and
``track_sequence``).

Host numpy, as the reference's: each frame's detections, in descending
score (a stable ``mergesort``, so equal scores keep their order), are
projected back by ``velocity * dt`` and matched to the nearest live track
of the same class within the class's gate (``DEFAULT_MATCH_DIST``); a
detection that matches none starts a track; a track unmatched for more
than ``max_age`` frames retires, and until then coasts along its velocity.
Coordinates must be shared across frames (nuScenes: the global frame,
through each record's ``global_from_lidar``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# nuScenes tracking evaluates 7 of the 10 detection classes (the official
# tracking_nips_2019 vocabulary; construction_vehicle / traffic_cone /
# barrier are static and excluded).
NUSCENES_TRACKING_CLASSES = (
    "bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer", "truck",
)

# Per-class gating distance in meters: how far a projected center may land
# from a track and still match. CenterPoint's published tracker derives these
# from per-class velocity error statistics (config constants, quoted widely);
# fast erratic classes (motorcycle) gate loose, pedestrians tight.
DEFAULT_MATCH_DIST: Dict[str, float] = {
    "car": 4.0, "truck": 4.0, "bus": 5.5, "trailer": 3.0,
    "pedestrian": 1.0, "motorcycle": 13.0, "bicycle": 3.0,
}


@dataclass
class _Track:
    track_id: int
    center: np.ndarray          # (2,) xy in the shared frame
    velocity: np.ndarray        # (2,) m/s
    cls: int
    score: float
    age: int = 0                # frames since last matched


@dataclass
class GreedyTracker:
    """Greedy center tracker over per-frame detections.

    ``class_names`` is REQUIRED and must be the detector's label vocabulary
    (e.g. ``data.nuscenes.DETECTION_CLASSES``): it maps the integer class
    ids detections carry to names used to look up the per-class gating
    distance. A defaulted vocabulary here would silently mis-gate (the
    detection and tracking vocabularies order classes differently). Ids
    without a name (or names without an entry) fall back to
    ``default_dist``.
    """

    class_names: Sequence[str]
    match_dist: Union[float, Dict[str, float], None] = None
    default_dist: float = 4.0
    max_age: int = 3
    _tracks: List[_Track] = field(default_factory=list)
    _next_id: int = 0

    def _gate(self, cls: int) -> float:
        table = DEFAULT_MATCH_DIST if self.match_dist is None else self.match_dist
        if isinstance(table, (int, float)):
            return float(table)
        if 0 <= cls < len(self.class_names):
            return float(table.get(self.class_names[cls], self.default_dist))
        return self.default_dist

    def reset(self) -> None:
        self._tracks = []
        self._next_id = 0

    def step(
        self,
        centers: np.ndarray,
        velocities: np.ndarray,
        classes: np.ndarray,
        scores: np.ndarray,
        time_lag: float,
    ) -> np.ndarray:
        """Advance one frame; returns an (N,) int64 track id per detection.

        ``time_lag`` is seconds since the previous frame of this sequence
        (ignored on the first frame). Detections are projected back by
        ``center - velocity * time_lag`` and matched against live track
        centers — equivalently, tracks are motion-compensated forward.
        """
        centers = np.asarray(centers, np.float64).reshape(-1, 2)
        velocities = np.nan_to_num(
            np.asarray(velocities, np.float64).reshape(-1, 2))
        classes = np.asarray(classes, np.int64).reshape(-1)
        scores = np.asarray(scores, np.float64).reshape(-1)
        n = len(centers)
        ids = np.full(n, -1, np.int64)

        projected = centers - velocities * float(time_lag)
        taken = np.zeros(len(self._tracks), bool)
        new_tracks: List[_Track] = []
        for di in np.argsort(-scores, kind="mergesort"):
            best, best_d = -1, np.inf
            gate = self._gate(int(classes[di]))
            # new detections this frame never match each other (CenterPoint
            # greedy-tracker semantics), so only pre-existing tracks compete
            for ti, tr in enumerate(self._tracks):
                if taken[ti] or tr.cls != classes[di]:
                    continue
                d = float(np.hypot(*(projected[di] - tr.center)))
                if d < best_d and d < gate:
                    best, best_d = ti, d
            if best >= 0:
                taken[best] = True
                tr = self._tracks[best]
                tr.center = centers[di].copy()
                tr.velocity = velocities[di].copy()
                tr.score = float(scores[di])
                tr.age = 0
                ids[di] = tr.track_id
            else:
                ids[di] = self._next_id
                new_tracks.append(_Track(
                    self._next_id, centers[di].copy(), velocities[di].copy(),
                    int(classes[di]), float(scores[di])))
                self._next_id += 1

        survivors = []
        for ti, tr in enumerate(self._tracks):
            if taken[ti]:
                survivors.append(tr)  # matched this frame
                continue
            tr.age += 1
            if tr.age > self.max_age:
                continue
            # coast unmatched tracks along their velocity so the next
            # frame's projection comparison stays aligned
            tr.center = tr.center + tr.velocity * float(time_lag)
            survivors.append(tr)
        self._tracks = survivors + new_tracks
        return ids


def track_sequence(
    frames: Sequence[Dict[str, np.ndarray]],
    class_names: Sequence[str],
    match_dist: Union[float, Dict[str, float], None] = None,
    max_age: int = 3,
) -> List[np.ndarray]:
    """Run the tracker over one ordered sequence.

    Each frame dict: ``centers`` (N,2), ``velocities`` (N,2), ``classes``
    (N,), ``scores`` (N,), ``timestamp`` (scalar, seconds); ``classes``
    index ``class_names`` (the detector vocabulary — see GreedyTracker).
    Returns the per-frame track id arrays.
    """
    tracker = GreedyTracker(
        class_names=class_names, match_dist=match_dist, max_age=max_age)
    out = []
    prev_t: Optional[float] = None
    for fr in frames:
        t = float(fr["timestamp"])
        dt = 0.0 if prev_t is None else t - prev_t
        out.append(tracker.step(
            fr["centers"], fr["velocities"], fr["classes"], fr["scores"], dt))
        prev_t = t
    return out
