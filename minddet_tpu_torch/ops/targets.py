"""CenterNet and CenterPoint training targets on the device: Gaussian
heatmaps, regression targets and gather indices (counterpart of
``minddet_tpu/ops/targets.py``).

Each object renders a full-plane truncated Gaussian and a scatter-max folds
the objects into their class planes, for a whole batch at once; the
reference's per-image ``jax.vmap`` is a batch dimension written out here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def gaussian_radius(det_size: Tuple[torch.Tensor, torch.Tensor],
                    min_overlap: float = 0.7) -> torch.Tensor:
    """Minimum Gaussian radius keeping IoU >= min_overlap under corner
    shifts: the reference's three-case quadratic, with its un-normalised
    /2 roots kept for parity."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2

    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(
        torch.clamp(b3 * b3 - 16 * min_overlap * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians(centers: torch.Tensor, radii: torch.Tensor,
                   classes: torch.Tensor, mask: torch.Tensor, height: int,
                   width: int, num_classes: int) -> torch.Tensor:
    """Render per-object truncated Gaussians into (B, H, W, C) heatmaps.

    centers (B, O, 2) float [x, y] in output-grid units; radii (B, O)
    float; classes (B, O) int; mask (B, O) bool validity. sigma = (2r+1)/6
    with r = floor(radius), truncated at r, max-merged into the class plane.
    Class indices are read as the reference's ``.at[cls].max(mode="drop")``
    reads them: a negative index counts from the end, and one still out of
    [0, C) is dropped.
    """
    b, o = classes.shape
    dev = centers.device
    cx = torch.floor(centers[..., 0]).float()
    cy = torch.floor(centers[..., 1]).float()
    r = torch.clamp(torch.floor(radii.float()), min=0.0)
    sigma = (2.0 * r + 1.0) / 6.0

    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    dy = ys - cy[..., None, None]  # (B, O, H, W)
    dx = xs - cx[..., None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma[..., None, None] ** 2))
    rr = r[..., None, None]
    inside = (dx.abs() <= rr) & (dy.abs() <= rr) & mask[..., None, None]
    g = torch.where(inside, g, torch.zeros((), device=dev))

    cls = torch.where(mask, classes, torch.zeros_like(classes)).long()
    cls = torch.where(cls < 0, cls + num_classes, cls)
    # dropped objects go to a spare plane C, sliced off below
    cls = torch.where((cls >= 0) & (cls < num_classes), cls,
                      torch.full_like(cls, num_classes))
    heat = torch.zeros(b, num_classes + 1, height * width,
                       dtype=torch.float32, device=dev)
    heat.scatter_reduce_(1, cls[..., None].expand(-1, -1, height * width),
                         g.reshape(b, o, height * width), "amax")
    heat = heat[:, :num_classes].reshape(b, num_classes, height, width)
    return heat.permute(0, 2, 3, 1).contiguous()


def centernet_targets_batch(boxes: torch.Tensor, classes: torch.Tensor,
                            mask: torch.Tensor, height: int, width: int,
                            num_classes: int, min_overlap: float = 0.7
                            ) -> Dict[str, torch.Tensor]:
    """All CenterNet training targets for a batch, on the device.

    boxes (B, O, 4) xyxy in output-grid units; classes (B, O) int; mask
    (B, O) validity. Returns hm (B, H, W, C) f32, wh (B, O, 2), reg (B, O,
    2), ind (B, O) int64 and the degeneracy-tightened reg_mask (B, O) f32.
    """
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = torch.clamp(x2 - x1, min=0.0)
    h = torch.clamp(y2 - y1, min=0.0)
    valid = mask.bool() & (w > 0) & (h > 0)

    radius = torch.floor(
        torch.clamp(gaussian_radius((h, w), min_overlap), min=0.0))
    cx = torch.clamp((x1 + x2) / 2.0, 0.0, width - 1.0)
    cy = torch.clamp((y1 + y2) / 2.0, 0.0, height - 1.0)
    hm = draw_gaussians(torch.stack([cx, cy], dim=-1), radius, classes,
                        valid, height, width, num_classes)

    cxi = torch.floor(cx)
    cyi = torch.floor(cy)
    ind = torch.where(valid, (cyi * width + cxi).long(),
                      torch.zeros((), dtype=torch.long, device=boxes.device))
    vf = valid.float()[..., None]
    return {
        "hm": hm,
        "wh": torch.stack([w, h], dim=-1) * vf,
        "reg": torch.stack([cx - cxi, cy - cyi], dim=-1) * vf,
        "ind": ind,
        "reg_mask": valid.float(),
    }


def centernet_targets(boxes: torch.Tensor, classes: torch.Tensor,
                      mask: torch.Tensor, height: int, width: int,
                      num_classes: int, min_overlap: float = 0.7
                      ) -> Dict[str, torch.Tensor]:
    """``centernet_targets_batch`` for one image: boxes (O, 4), classes and
    mask (O,); hm (H, W, C) and the (O, ...) columns."""
    out = centernet_targets_batch(boxes[None], classes[None], mask[None],
                                  height, width, num_classes, min_overlap)
    return {k: v[0] for k, v in out.items()}


def centerpoint_targets_batch(gt_boxes: torch.Tensor,
                              gt_classes: torch.Tensor,
                              gt_mask: torch.Tensor,
                              feature_size: Tuple[int, int],
                              num_classes: int,
                              pc_range: Sequence[float],
                              voxel_size: Sequence[float],
                              out_size_factor: int = 4,
                              gaussian_overlap: float = 0.1,
                              min_radius: float = 2.0
                              ) -> Dict[str, torch.Tensor]:
    """Targets of one CenterHead task group for a batch, on the device.

    gt_boxes (B, O, 9) [x, y, z, w, l, h, vx, vy, yaw] in the world, padded;
    gt_classes (B, O) int class within the task (0-based); gt_mask (B, O)
    validity. Returns hm (B, H, W, C) f32, anno_box (B, O, 10) [dx, dy, z,
    log w, log l, log h, vx, vy, sin yaw, cos yaw], ind (B, O) int64, mask
    (B, O) f32 and cat (B, O) int64; a box is valid when its footprint is
    positive and its centre lies on the map. (The reference's ``max_objs``
    argument is read by nothing there: the O slots are kept as they are.)"""
    h, w = feature_size
    vx_sz = voxel_size[0] * out_size_factor
    vy_sz = voxel_size[1] * out_size_factor
    gt_boxes = gt_boxes.float()
    x, y, z, dx, dy, dz, vel_x, vel_y, rot = gt_boxes.unbind(-1)

    gw = dx / vx_sz  # footprint in feature-map cells
    gl = dy / vy_sz
    radius = torch.clamp(
        torch.floor(gaussian_radius((gl, gw), gaussian_overlap)),
        min=min_radius)
    cx = (x - pc_range[0]) / vx_sz
    cy = (y - pc_range[1]) / vy_sz
    valid = (gt_mask.bool() & (gw > 0) & (gl > 0)
             & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
    cx = torch.clamp(cx, 0.0, w - 1e-3)
    cy = torch.clamp(cy, 0.0, h - 1e-3)
    hm = draw_gaussians(torch.stack([cx, cy], dim=-1), radius, gt_classes,
                        valid, h, w, num_classes)

    cxi = torch.floor(cx)
    cyi = torch.floor(cy)
    zero = torch.zeros((), dtype=torch.long, device=gt_boxes.device)
    anno_box = torch.stack(
        [cx - cxi, cy - cyi, z, torch.log(torch.clamp(dx, min=1e-6)),
         torch.log(torch.clamp(dy, min=1e-6)),
         torch.log(torch.clamp(dz, min=1e-6)), vel_x, vel_y, torch.sin(rot),
         torch.cos(rot)], dim=-1) * valid[..., None]
    return {
        "hm": hm,
        "anno_box": anno_box,
        "ind": torch.where(valid, (cyi * w + cxi).long(), zero),
        "mask": valid.float(),
        "cat": torch.where(valid, gt_classes.long(), zero),
    }


def centerpoint_targets(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                        gt_mask: torch.Tensor, *args, **kwargs
                        ) -> Dict[str, torch.Tensor]:
    """``centerpoint_targets_batch`` for one sample: gt_boxes (O, 9),
    gt_classes and gt_mask (O,); hm (H, W, C) and the (O, ...) columns."""
    out = centerpoint_targets_batch(gt_boxes[None], gt_classes[None],
                                    gt_mask[None], *args, **kwargs)
    return {k: v[0] for k, v in out.items()}
