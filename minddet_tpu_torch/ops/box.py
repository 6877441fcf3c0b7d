"""Box helpers of the PointPillars and CenterPoint paths (counterpart of the
parts of ``minddet_tpu/ops/box.py`` they use, plus the
rotated-rectangle corners of ``minddet_tpu/ops/rotated_iou_pallas.py:
_corners``).

Boxes are [x, y, z, w, l, h, yaw] in 3D and [x, y, w, l, yaw] in BEV; w runs
along the box's own x axis and l along its y axis, yaw counter-clockwise.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_2d(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 2) point sets counter-clockwise; ``angles`` must
    broadcast against ``points[..., 0]``."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


# corner k of ``center_to_corner_box2d``, in units of (w, l): counter-
# clockwise from (-w/2, -l/2) in the box's own frame
_CORNER_SIGNS_2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def center_to_corner_box2d(centers: torch.Tensor, dims: torch.Tensor,
                           angles: torch.Tensor) -> torch.Tensor:
    """(..., 2) centres, (..., 2) dims, (...,) yaw -> (..., 4, 2) corners,
    in the reference's corner order."""
    signs = torch.tensor(_CORNER_SIGNS_2D, dtype=dims.dtype,
                         device=dims.device)
    corners = rotation_2d(dims[..., None, :] * signs, angles[..., None])
    return corners + centers[..., None, :]


def second_box_decode(encodings: torch.Tensor, anchors: torch.Tensor
                      ) -> torch.Tensor:
    """SECOND residuals (..., 7) against anchors (..., 7) -> boxes (..., 7),
    z at the box bottom."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = encodings.unbind(-1)
    diag = torch.sqrt(wa * wa + la * la)
    za = za + ha / 2
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    return torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)


def second_box_encode(boxes: torch.Tensor, anchors: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Boxes (..., 7) against anchors (..., 7) -> SECOND residuals (..., 7),
    the inverse of ``second_box_decode`` (log sizes; every divisor and log
    argument kept above ``eps``)."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.unbind(-1)
    diag = torch.sqrt(wa * wa + la * la).clamp(min=eps)
    zg = zg + hg / 2
    za = za + ha / 2
    return torch.stack(
        [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha.clamp(min=eps),
         torch.log(wg.clamp(min=eps) / wa.clamp(min=eps)),
         torch.log(lg.clamp(min=eps) / la.clamp(min=eps)),
         torch.log(hg.clamp(min=eps) / ha.clamp(min=eps)), rg - ra], dim=-1)


def rbbox_to_near_bbox(rboxes: torch.Tensor) -> torch.Tensor:
    """Rotated BEV [x, y, w, l, yaw] -> the nearest axis-aligned [x1, y1,
    x2, y2]: w and l swap when the yaw is nearer 90 than 0 degrees."""
    x, y, w, l, yaw = rboxes.unbind(-1)
    swap = torch.abs(limit_period(yaw, 0.5, math.pi)) > math.pi / 4
    we = torch.where(swap, l, w)
    le = torch.where(swap, w, l)
    return torch.stack([x - we / 2, y - le / 2, x + we / 2, y + le / 2],
                       dim=-1)


# corner k of a box sits at (w * CORNER_SIGNS[k][0], l * CORNER_SIGNS[k][1])
# in its own frame: counter-clockwise from the (+w/2, +l/2) corner
CORNER_SIGNS = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def rect_corner_offsets(w: torch.Tensor, l: torch.Tensor, yaw: torch.Tensor
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 4 counter-clockwise corners of rotated rectangles relative to
    their centres: [(dx, dy)] * 4, each broadcast like the inputs."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    out = []
    for sx, sy in CORNER_SIGNS:
        ox, oy = w * sx, l * sy
        out.append((c * ox - s * oy, s * ox + c * oy))
    return out
