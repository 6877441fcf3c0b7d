"""Box helpers of the PointPillars, CenterPoint, R-CNN and YOLO paths
(counterpart of the parts of ``minddet_tpu/ops/box.py`` they use, plus the
rotated-rectangle corners of ``minddet_tpu/ops/rotated_iou_pallas.py:
_corners``).

Axis-aligned 2D boxes are [x1, y1, x2, y2]. Boxes are [x, y, z, w, l, h,
yaw] in 3D and [x, y, w, l, yaw] in BEV; w runs along the box's own x axis
and l along its y axis, yaw counter-clockwise.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] corner boxes (0 for a box with x2 < x1 or y2 <
    y1)."""
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """IoU of (..., N, 4) and (..., M, 4) corner boxes -> (..., N, M); the
    union is kept above ``eps``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """IoU of corner boxes of the same leading shape (..., 4) -> (...); the
    union is kept above ``eps``."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1) + area(boxes2) - inter
    return inter / union.clamp(min=eps)


def elementwise_ciou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Complete IoU of corner boxes of the same leading shape (..., 4) ->
    (...): IoU - (centre distance)² / (enclosing box's diagonal)² - alpha v,
    v = 4 / pi² (atan(w2 / h2) - atan(w1 / h1))² (Zheng et al., 2020),
    widths, heights and the diagonal kept at ``eps`` or above (JAX's
    ``maximum``: a tie passes half the gradient); alpha = v / (1 - IoU + v)
    is detached, as the reference stops its gradient."""
    def at_least(x):
        return torch.maximum(x, torch.full_like(x, eps))

    iou = elementwise_iou(boxes1, boxes2, eps)
    c1 = (boxes1[..., :2] + boxes1[..., 2:4]) * 0.5
    c2 = (boxes2[..., :2] + boxes2[..., 2:4]) * 0.5
    rho2 = ((c1 - c2) ** 2).sum(-1)
    enc_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_rb = torch.maximum(boxes1[..., 2:4], boxes2[..., 2:4])
    diag2 = ((enc_rb - enc_lt) ** 2).sum(-1)
    w1 = at_least(boxes1[..., 2] - boxes1[..., 0])
    h1 = at_least(boxes1[..., 3] - boxes1[..., 1])
    w2 = at_least(boxes2[..., 2] - boxes2[..., 0])
    h2 = at_least(boxes2[..., 3] - boxes2[..., 1])
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2)
                                 - torch.atan(w1 / h1)) ** 2
    alpha = (v / at_least(1.0 - iou + v)).detach()
    return iou - rho2 / at_least(diag2) - alpha * v


def clip_boxes(boxes: torch.Tensor, height: float, width: float
               ) -> torch.Tensor:
    """Clip [..., 4] corner boxes into [0, width] x [0, height]."""
    return torch.stack([boxes[..., 0].clamp(0, width),
                        boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width),
                        boxes[..., 3].clamp(0, height)], dim=-1)


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor,
                  means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                  max_wh_ratio: float = 16.0) -> torch.Tensor:
    """R-CNN deltas [dx, dy, dw, dh] (..., 4) against corner anchors (...,
    4) -> corner boxes: ``d = deltas * stds + means``, centres moved by
    (dx, dy) anchor sizes, sizes scaled by exp of dw and dh clamped to
    +-log(``max_wh_ratio``)."""
    d = (deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
         + torch.tensor(means, dtype=deltas.dtype, device=deltas.device))
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    limit = math.log(max_wh_ratio)
    gx = ax + d[..., 0] * aw
    gy = ay + d[..., 1] * ah
    gw = aw * torch.exp(d[..., 2].clamp(-limit, limit))
    gh = ah * torch.exp(d[..., 3].clamp(-limit, limit))
    return torch.stack([gx - gw / 2, gy - gh / 2, gx + gw / 2, gy + gh / 2],
                       dim=-1)


def encode_deltas(boxes: torch.Tensor, anchors: torch.Tensor,
                  means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                  eps: float = 1e-6) -> torch.Tensor:
    """Corner boxes (..., 4) against corner anchors (..., 4) -> R-CNN deltas
    [dx, dy, dw, dh] (..., 4), ``(d - means) / stds``: the centre offset in
    anchor sizes and the log size ratios, every width and height kept at
    ``eps`` or above, so that a zero-area box or anchor gives large but
    finite deltas. The inverse of ``decode_deltas``."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=eps)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=eps)
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = (boxes[..., 2] - boxes[..., 0]).clamp(min=eps)
    gh = (boxes[..., 3] - boxes[..., 1]).clamp(min=eps)
    gx = (boxes[..., 0] + boxes[..., 2]) / 2
    gy = (boxes[..., 1] + boxes[..., 3]) / 2
    d = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], dim=-1)
    return ((d - torch.tensor(means, dtype=d.dtype, device=d.device))
            / torch.tensor(stds, dtype=d.dtype, device=d.device))


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
