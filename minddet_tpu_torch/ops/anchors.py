"""3D anchor grids, the BEV-occupancy anchor mask and the anchor
assignment (counterpart of the parts of ``minddet_tpu/ops/anchors.py`` the
PointPillars paths use: ``create_anchors_3d_stride``, ``ClassAnchorConfig``,
``generate_anchors``, ``anchors_bev_area_mask``, ``make_grid_area_mask``,
``distance_similarity`` and ``assign_targets_batch``).

The anchor grids are numpy, computed once per configuration, as in the
reference. The mask and the assignment are computed on the device, the
assignment for the whole batch at once where the reference vmaps one
sample at a time.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from minddet_tpu_torch.ops.box import (pairwise_iou, rbbox_to_near_bbox,
                                       second_box_encode)
from minddet_tpu_torch.ops.voxelize import voxel_cell_rows


def create_anchors_3d_stride(
    feature_size: Tuple[int, int],
    sizes: Sequence[float] = (1.6, 3.9, 1.56),
    anchor_strides: Sequence[float] = (0.4, 0.4, 0.0),
    anchor_offsets: Sequence[float] = (0.2, -39.8, -1.78),
    rotations: Sequence[float] = (0.0, float(np.pi / 2)),
) -> np.ndarray:
    """Strided anchor grid -> (ny, nx, n_size, n_rot, 7) float32 [x, y, z,
    w, l, h, yaw], centres at offset + index * stride."""
    ny, nx = feature_size
    sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
    rotations = np.asarray(rotations, np.float32)
    xs = anchor_offsets[0] + np.arange(nx, dtype=np.float32) * anchor_strides[0]
    ys = anchor_offsets[1] + np.arange(ny, dtype=np.float32) * anchor_strides[1]
    out = np.zeros((ny, nx, sizes.shape[0], rotations.shape[0], 7),
                   np.float32)
    out[..., 0] = xs[None, :, None, None]
    out[..., 1] = ys[:, None, None, None]
    out[..., 2] = np.float32(anchor_offsets[2])
    out[..., 3:6] = sizes[None, None, :, None, :]
    out[..., 6] = rotations[None, None, None, :]
    return out


class ClassAnchorConfig(NamedTuple):
    """Per-class anchor spec."""

    name: str
    sizes: Tuple[float, ...]
    strides: Tuple[float, ...]
    offsets: Tuple[float, ...]
    rotations: Tuple[float, ...] = (0.0, float(np.pi / 2))
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45


def generate_anchors(feature_size: Tuple[int, int],
                     configs: Sequence[ClassAnchorConfig]
                     ) -> Dict[str, np.ndarray]:
    """Per-class anchor grids concatenated per cell: anchors (A, 7) and the
    per-anchor matched/unmatched thresholds (A,)."""
    all_anchors, m_th, u_th = [], [], []
    for cfg in configs:
        a = create_anchors_3d_stride(
            feature_size, cfg.sizes, cfg.strides, cfg.offsets, cfg.rotations
        ).reshape(feature_size[0], feature_size[1], -1, 7)
        shape = a.shape[:3]
        all_anchors.append(a)
        m_th.append(np.full(shape, cfg.matched_threshold, np.float32))
        u_th.append(np.full(shape, cfg.unmatched_threshold, np.float32))
    return {
        "anchors": np.concatenate(all_anchors, axis=2).reshape(-1, 7),
        "matched_threshold": np.concatenate(m_th, axis=2).reshape(-1),
        "unmatched_threshold": np.concatenate(u_th, axis=2).reshape(-1),
    }


def occupancy_from_coords(coords: torch.Tensor, ny: int, nx: int
                          ) -> torch.Tensor:
    """Voxel coords (B, V, 3) [gz, gy, gx] (-1 = empty) -> the (B, ny, nx)
    f32 0/1 map of the BEV cells that hold a voxel."""
    b = coords.shape[0]
    occ = torch.zeros(b * ny * nx + 1, dtype=torch.float32,
                      device=coords.device)
    occ.index_fill_(0, voxel_cell_rows(coords, ny, nx).reshape(-1), 1.0)
    return occ[:b * ny * nx].view(b, ny, nx)


def anchors_bev_area_mask(coords: torch.Tensor, anchors_bev: torch.Tensor,
                          grid_shape: Tuple[int, int],
                          voxel_size: Sequence[float],
                          pc_range: Sequence[float],
                          area_threshold: float = 1.0) -> torch.Tensor:
    """The anchor-area mask of any anchor layout: an anchor is kept when
    more than ``area_threshold`` occupied BEV cells lie under its
    footprint. ``coords`` (B, V, 3) [gz, gy, gx] (-1 = empty);
    ``anchors_bev`` (A, 4) axis-aligned [x1, y1, x2, y2] in metres ->
    (B, A) bool.

    Each footprint is counted on the occupancy's integral image with four
    lookups; its cell bounds are floor((edge - origin) / size + 1e-3)
    clipped to the grid (the nudge settles edges that lie on a cell
    boundary, as ``make_grid_area_mask`` does, so the two agree)."""
    ny, nx = grid_shape
    occ = occupancy_from_coords(coords, ny, nx)
    integral = F.pad(torch.cumsum(torch.cumsum(occ, dim=1), dim=2),
                     (1, 0, 1, 0)).flatten(1)
    dev = coords.device
    vs = torch.tensor(voxel_size[:2], dtype=torch.float32, device=dev)
    origin = torch.tensor(pc_range[:2], dtype=torch.float32, device=dev)
    eps = 1e-3

    def cell(col, axis, hi):
        return torch.clamp(torch.floor((anchors_bev[:, col] - origin[axis])
                                       / vs[axis] + eps), 0, hi).long()

    x1, y1 = cell(0, 0, nx - 1), cell(1, 1, ny - 1)
    x2, y2 = cell(2, 0, nx - 1), cell(3, 1, ny - 1)
    at = lambda y, x: integral[:, y * (nx + 1) + x]
    area = at(y2 + 1, x2 + 1) - at(y1, x2 + 1) - at(y2 + 1, x1) + at(y1, x1)
    return area > area_threshold


def make_grid_area_mask(
    grid_shape: Tuple[int, int],
    voxel_size: Sequence[float],
    pc_range: Sequence[float],
    feature_size: Tuple[int, int],
    configs: Sequence[ClassAnchorConfig],
    area_threshold: float = 1.0,
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The anchor-area mask for a regular strided anchor grid: an anchor is
    kept when more than ``area_threshold`` occupied BEV cells lie under its
    footprint.

    Each (class, size, rotation) combination's footprint query is one
    strided box filter, as cumulative sums along each axis and strided
    differences. Returns ``from_occ(occ (B, ny, nx)) -> (B, A) bool`` in
    ``generate_anchors`` order, or None when the layout does not qualify
    (a stride that is not a whole number of cells, rotations other than 0
    and pi/2). Cells outside the grid count as empty.
    """
    ny, nx = grid_shape
    fny, fnx = feature_size
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    ox, oy = float(pc_range[0]), float(pc_range[1])

    combos = []  # (ky, kx, wh, ww, y0, x0) per anchor cell
    for cfg in configs:
        sx, sy = float(cfg.strides[0]), float(cfg.strides[1])
        kx, ky = sx / vx, sy / vy
        if abs(kx - round(kx)) > 1e-6 or abs(ky - round(ky)) > 1e-6:
            return None
        kx, ky = int(round(kx)), int(round(ky))
        for s in np.asarray(cfg.sizes, np.float32).reshape(-1, 3):
            w, l = float(s[0]), float(s[1])
            for rot in cfg.rotations:
                r = abs(float(rot)) % np.pi
                if min(r, np.pi - r) > 1e-6 and abs(r - np.pi / 2) > 1e-6:
                    return None
                ex, ey = (l, w) if abs(r - np.pi / 2) <= 1e-6 else (w, l)
                # floors nudged by eps: footprints of the stock configs
                # sit exactly on cell boundaries
                eps = 1e-3
                x1 = int(np.floor((cfg.offsets[0] - ex / 2 - ox) / vx + eps))
                y1 = int(np.floor((cfg.offsets[1] - ey / 2 - oy) / vy + eps))
                x2 = int(np.floor((cfg.offsets[0] + ex / 2 - ox) / vx + eps))
                y2 = int(np.floor((cfg.offsets[1] + ey / 2 - oy) / vy + eps))
                combos.append((ky, kx, y2 - y1 + 1, x2 - x1 + 1, y1, x1))

    pad_t = max(0, max(-c[4] for c in combos))
    pad_l = max(0, max(-c[5] for c in combos))
    pad_b = max(0, max(c[4] + c[2] + (fny - 1) * c[0] - ny for c in combos))
    pad_r = max(0, max(c[5] + c[3] + (fnx - 1) * c[1] - nx for c in combos))

    def from_occ(occ: torch.Tensor) -> torch.Tensor:
        occ = F.pad(occ.float(), (pad_l, pad_r, pad_t, pad_b))
        cx = F.pad(torch.cumsum(occ, dim=-1), (1, 0))
        masks = []
        for ky, kx, wh, ww, y0, x0 in combos:
            c_lo = pad_l + x0
            rowsum = (cx[..., c_lo + ww:c_lo + ww + kx * (fnx - 1) + 1:kx]
                      - cx[..., c_lo:c_lo + kx * (fnx - 1) + 1:kx])
            cy = F.pad(torch.cumsum(rowsum, dim=-2), (0, 0, 1, 0))
            r_lo = pad_t + y0
            area = (cy[..., r_lo + wh:r_lo + wh + ky * (fny - 1) + 1:ky, :]
                    - cy[..., r_lo:r_lo + ky * (fny - 1) + 1:ky, :])
            masks.append(area > area_threshold)
        return torch.stack(masks, dim=-1).flatten(-3)

    from_occ.from_coords = lambda coords: from_occ(
        occupancy_from_coords(coords, ny, nx))
    return from_occ


def distance_similarity(boxes1: torch.Tensor, boxes2: torch.Tensor,
                        distance_norm: float = 2.0) -> torch.Tensor:
    """Centre-distance similarity of (..., N, 5) and (..., M, 5) BEV boxes
    [x, y, w, l, yaw] -> (..., N, M): ``1 - ||c1 - c2|| / distance_norm``,
    so that a matched threshold keeps its >= meaning."""
    d = boxes1[..., :, None, :2] - boxes2[..., None, :, :2]
    return 1.0 - torch.sqrt((d * d).sum(-1)) / distance_norm


@torch.no_grad()
def assign_targets_batch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                         matched_threshold: torch.Tensor,
                         unmatched_threshold: torch.Tensor,
                         anchors_mask: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """SECOND's anchor assignment for a batch in one pass over (B, A, G).

    anchors (A, 7); gt_boxes (B, G, 7) padded; gt_classes (B, G) 1-based;
    gt_mask (B, G); thresholds (A,); anchors_mask (B, A) or None. Returns
    labels (B, A) int32 (-1 ignored, 0 background, else the class),
    bbox_targets (B, A, 7) (the SECOND residual of the matched box, 0 off
    the foreground) and reg_weights (B, A).

    The similarity is the nearest axis-aligned BEV IoU, -1 at padded
    ground truth and masked anchors.
    An anchor is positive at or above its matched threshold and negative
    below its unmatched one; every anchor that reaches a ground-truth box's
    best non-zero similarity is positive too, ties included. Each anchor
    takes the class and box of its first most similar ground truth."""
    near_anchors = rbbox_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
    near_gt = rbbox_to_near_bbox(gt_boxes[..., [0, 1, 3, 4, 6]])
    iou = pairwise_iou(near_anchors, near_gt)  # (B, A, G)
    gt_mask = gt_mask.bool()
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    if anchors_mask is not None:
        iou = torch.where(anchors_mask[:, :, None], iou, -1.0)

    # torch.max over a dim returns the first index of the maximum, as
    # jnp.argmax does
    anchor_to_gt_max, anchor_to_gt = iou.max(dim=-1)
    gt_best = iou.amax(dim=1)  # (B, G)
    gt_best = torch.where(gt_best <= 0, -1.0, gt_best)
    force = ((iou == gt_best[:, None, :]) & gt_mask[:, None, :]
             & (iou > 0)).any(dim=-1)
    pos = anchor_to_gt_max >= matched_threshold
    neg = anchor_to_gt_max < unmatched_threshold

    labels = torch.where(neg, 0, -1).to(torch.int32)
    assigned = torch.gather(gt_classes.to(torch.int32), 1, anchor_to_gt)
    labels = torch.where(pos | force, assigned, labels)
    if anchors_mask is not None:
        labels = torch.where(anchors_mask, labels, -1)
    matched = torch.gather(
        gt_boxes, 1, anchor_to_gt[..., None].expand(-1, -1,
                                                    gt_boxes.shape[-1]))
    fg = labels > 0
    targets = torch.where(fg[..., None], second_box_encode(matched, anchors),
                          0.0)
    return {"labels": labels, "bbox_targets": targets,
            "reg_weights": fg.to(torch.float32)}
