"""Detection visualization: boxes and labels on an image, a LiDAR bird's-eye
view with rotated boxes (counterpart of ``minddet_tpu/utils/visual.py``).

Host code on numpy arrays, drawn with cv2, which is imported inside the
calls: the GPU host has none, and nothing else of the port needs it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_PALETTE = np.array(
    [
        (216, 82, 24), (0, 113, 188), (118, 171, 47), (236, 176, 31),
        (125, 46, 141), (76, 189, 237), (161, 19, 46), (0, 166, 90),
    ],
    np.uint8,
)


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.3,
    thickness: int = 2,
) -> np.ndarray:
    """Draw xyxy boxes, with a "name score" caption each, on a copy of an
    image (uint8 HWC BGR); boxes under ``score_threshold`` or with a
    negative label are skipped. (The reference's draws into a contiguous
    uint8 input itself, though it says it returns a copy.)"""
    import cv2

    img = np.array(image, np.uint8, order="C")
    boxes = np.asarray(boxes).reshape(-1, 4)
    n = len(boxes)
    scores = np.ones(n) if scores is None else np.asarray(scores).reshape(-1)
    labels = (np.zeros(n, int) if labels is None
              else np.asarray(labels, int).reshape(-1))
    for i in range(n):
        if scores[i] < score_threshold or labels[i] < 0:
            continue
        color = tuple(int(c) for c in _PALETTE[labels[i] % len(_PALETTE)])
        x1, y1, x2, y2 = (int(round(v)) for v in boxes[i])
        cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness)
        name = (class_names[labels[i]]
                if class_names is not None
                and 0 <= labels[i] < len(class_names)
                else str(labels[i]))
        cv2.putText(img, f"{name} {scores[i]:.2f}", (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return img


def rect_corners(boxes: np.ndarray) -> np.ndarray:
    """(..., 5) rotated boxes [x, y, w, l, yaw] -> (..., 4, 2) f32 corners
    in counter-clockwise order."""
    b = torch.from_numpy(np.asarray(boxes, np.float32))
    x, y, w, l, r = (b[..., i] for i in range(5))
    dx = torch.stack([w, -w, -w, w], dim=-1) * 0.5
    dy = torch.stack([l, l, -l, -l], dim=-1) * 0.5
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    cx = c * dx - s * dy + x[..., None]
    cy = s * dx + c * dy + y[..., None]
    return torch.stack([cx, cy], dim=-1).numpy()


def draw_bev(
    points: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
    resolution: int = 768,
) -> np.ndarray:
    """Render a LiDAR bird's-eye view (points grey) with the rotated BEV
    outlines of (N, 7+) boxes [x, y, z, w, l, h, ..., yaw] -> a uint8
    (resolution, resolution, 3) image."""
    import cv2

    img = np.zeros((resolution, resolution, 3), np.uint8)
    x0, y0, _, x1, y1, _ = pc_range
    sx = resolution / (x1 - x0)
    sy = resolution / (y1 - y0)
    px = ((points[:, 0] - x0) * sx).astype(int)
    py = ((points[:, 1] - y0) * sy).astype(int)
    ok = (px >= 0) & (px < resolution) & (py >= 0) & (py < resolution)
    img[py[ok], px[ok]] = (90, 90, 90)
    if boxes is not None and len(boxes):
        corners = rect_corners(np.asarray(boxes)[:, [0, 1, 3, 4, -1]])
        for bi, c in enumerate(corners):
            pts = np.stack([(c[:, 0] - x0) * sx, (c[:, 1] - y0) * sy],
                           -1).astype(np.int32)
            color = tuple(int(v) for v in _PALETTE[bi % len(_PALETTE)])
            cv2.polylines(img, [pts.reshape(-1, 1, 2)], True, color, 2)
    return img
