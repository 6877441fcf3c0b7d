"""2D anchors of the R-CNN family and their training targets (counterpart
of ``minddet_tpu/ops/anchors2d.py``: ``grid_anchors``, ``multilevel_anchors``,
``match_anchors``, ``sample_balanced`` and ``rpn_targets``).

Anchors are static: numpy grids computed once when a model is built, which
the model keeps f32 on its device outside its buffers (a cast of the model
to bf16 leaves them f32, as the reference keeps them). Boxes are [x1, y1,
x2, y2] in input pixels.

The targets are batched over images where the reference vmaps one image at
a time, and take their uniform draws as tensors where the reference takes a
key: ``jax.random`` cannot be reproduced in torch, so a caller draws them
(``torch.rand`` from a generator) or passes the reference's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from minddet_tpu_torch.ops.box import encode_deltas, pairwise_iou


def grid_anchors(feature_hw: Tuple[int, int], stride: int,
                 scales: Sequence[float] = (8.0,),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """(H * W * A, 4) f32 anchors of one level, position-major (row, then
    column, then anchor): centres at (i + 0.5) * stride, for each scale s
    and ratio r a box of s * stride * (sqrt(1 / r), sqrt(r))."""
    h, w = feature_hw
    base = []
    for s in scales:
        for r in ratios:
            size = s * stride
            bw = size * np.sqrt(1.0 / r)
            bh = size * np.sqrt(r)
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    base = np.asarray(base, np.float32)
    ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
    xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def level_shape(image_hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """A pyramid level's (H, W): the image's sides over the stride, rounded
    up."""
    return -(-image_hw[0] // stride), -(-image_hw[1] // stride)


def multilevel_anchors(image_hw: Tuple[int, int], strides: Sequence[int],
                       scales: Sequence[float] = (8.0,),
                       ratios: Sequence[float] = (0.5, 1.0, 2.0),
                       scales_per_level: Optional[Sequence[Sequence[float]]]
                       = None) -> np.ndarray:
    """Every level's ``grid_anchors`` concatenated -> (A_total, 4); a level
    takes ``scales_per_level[i]`` where given, else ``scales``."""
    out = []
    for li, s in enumerate(strides):
        sc = scales_per_level[li] if scales_per_level is not None else scales
        out.append(grid_anchors(level_shape(image_hw, s), s, sc, ratios))
    return np.concatenate(out, axis=0)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_mask: torch.Tensor, pos_iou: float = 0.7,
                  neg_iou: float = 0.3, force_match: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-IoU matcher of anchors (A, 4) or (B, A, 4) to ground truth (B,
    G, 4) with its mask (B, G) -> (labels (B, A) int64: 1 positive, 0
    negative, -1 ignored; the matched GT index (B, A)).

    A masked GT reads IoU -1. An anchor is negative below ``neg_iou`` and
    positive from ``pos_iou`` on; with ``force_match`` every anchor that
    holds some valid GT's largest IoU (ties included, the IoU above 0) is
    positive too. The matched index is the first GT of the largest IoU, as
    ``jnp.argmax`` takes it (GT 0 where no GT is valid)."""
    iou = pairwise_iou(anchors, gt_boxes)  # (B, A, G)
    valid = gt_mask[..., None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, -1.0))
    a_max = iou.amax(dim=-1)
    a_arg = torch.argmax(iou, dim=-1)
    labels = torch.full(a_max.shape, -1, dtype=torch.int64,
                        device=iou.device)
    labels = torch.where(a_max < neg_iou, torch.zeros_like(labels), labels)
    labels = torch.where(a_max >= pos_iou, torch.ones_like(labels), labels)
    if force_match:
        g_best = iou.amax(dim=-2, keepdim=True)
        forced = ((iou == g_best) & (iou > 0) & valid).any(dim=-1)
        labels = torch.where(forced, torch.ones_like(labels), labels)
    return labels, a_arg


def sample_balanced(u1: torch.Tensor, u2: torch.Tensor, labels: torch.Tensor,
                    num_samples: int = 256, pos_fraction: float = 0.5
                    ) -> torch.Tensor:
    """Fixed-size positive / negative sampling -> a weight mask (B, A) f32
    in {0, 1}. ``u1`` and ``u2`` (B, A) are the reference's two uniform
    draws (its ``r1`` and ``r2``): positives rank by ``u1`` and at most
    ``num_samples * pos_fraction`` of them are kept (every positive whose
    draw reaches the cap's, ties included), then kept positives take
    priority 2 + u1 and negatives 1 + u2, and every candidate whose
    priority reaches the ``num_samples``-th largest (at least 1) is chosen,
    ties included. The sums round in the draws' type, as the reference's
    do."""
    a = labels.shape[-1]
    num_pos = int(num_samples * pos_fraction)
    pos = labels == 1
    neg = labels == 0
    pos_key = torch.where(pos, u1, torch.full_like(u1, -1.0))
    kth = torch.topk(pos_key, min(num_pos, a), dim=-1).values[..., -1:]
    pos_keep = pos & (pos_key >= kth.clamp(min=0.0))
    pri = torch.where(pos_keep, 2.0 + u1,
                      torch.where(neg, 1.0 + u2, torch.zeros_like(u2)))
    thresh = torch.topk(pri, min(num_samples, a), dim=-1).values[..., -1:]
    chosen = (pri >= thresh.clamp(min=1.0)) & (pos_keep | neg)
    return chosen.to(torch.float32)


def rpn_targets(u1: torch.Tensor, u2: torch.Tensor, anchors: torch.Tensor,
                gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                num_samples: int = 256, pos_iou: float = 0.7,
                neg_iou: float = 0.3) -> Dict[str, torch.Tensor]:
    """The RPN's training targets of a batch: ``match_anchors`` (forced
    matches on), ``sample_balanced`` with half positives on the draws
    ``u1``, ``u2`` (B, A), and each anchor's deltas to its matched GT ->
    labels (B, A), deltas (B, A, 4), cls_weights (B, A) and reg_weights
    (the sampled positives)."""
    labels, match = match_anchors(anchors, gt_boxes, gt_mask, pos_iou,
                                  neg_iou)
    weights = sample_balanced(u1, u2, labels, num_samples, 0.5)
    matched = torch.gather(gt_boxes, 1, match[..., None].expand(-1, -1, 4))
    deltas = encode_deltas(matched, anchors)
    pos = (labels == 1).to(torch.float32)
    return {"labels": labels, "deltas": deltas, "cls_weights": weights,
            "reg_weights": weights * pos}
