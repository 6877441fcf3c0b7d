"""Box helpers of the PointPillars predict path (counterpart of the parts of
``minddet_tpu/ops/box.py`` it uses, plus the rotated-rectangle corners of
``minddet_tpu/ops/rotated_iou_pallas.py:_corners``).

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
