"""R-CNN ROI heads (counterpart of ``minddet_tpu/models/heads/
roi_head.py``): ``BoxHead``, ``MaskHead`` and ``box_head_predict`` for
inference; ``sample_proposals``, ``box_head_loss`` and ``mask_head_loss``
for training, batched over images where the reference vmaps one image at a
time, with the sampler's uniform draws passed in as tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import (Conv2d, ConvTranspose2d, Linear,
                                             take_rows)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.ops.anchors2d import match_anchors, sample_balanced
from minddet_tpu_torch.ops.box import clip_boxes, decode_deltas, encode_deltas
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import batched_nms
from minddet_tpu_torch.ops.roi_align import roi_align

BBOX_REG_STDS = (0.1, 0.1, 0.2, 0.2)


class BoxHead(nn.Module):
    """ROI features (B, R, 7, 7, C) -> two FC layers with ReLU -> (C + 1)
    class logits and num_classes x 4 deltas, both f32 (f64 for an f64
    model). The features are
    flattened in NHWC order (row, column, channel), the reference's, so
    that its ``fc1`` kernel applies as it is; they compute in their own
    type (cast them to the compute dtype first)."""

    def __init__(self, in_features: int, num_classes: int = 80,
                 fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = Linear(in_features, fc_dim)
        self.fc2 = Linear(fc_dim, fc_dim)
        self.cls = Linear(fc_dim, num_classes + 1)
        self.reg = Linear(fc_dim, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, r = roi_feats.shape[:2]
        x = roi_feats.reshape(b, r, -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        out = torch.promote_types(x.dtype, torch.float32)
        return (self.cls(x).to(out),
                self.reg(x).reshape(b, r, self.num_classes, 4).to(out))


class MaskHead(nn.Module):
    """ROI features (B, R, 14, 14, C) -> four 3x3 convs with ReLU -> a 2x2
    stride-2 transposed conv with ReLU -> 1x1 to num_classes -> (B, R, 28,
    28, num_classes) logits in f32 (f64 for an f64 model)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 channels: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1))
        self.up = ConvTranspose2d(channels, channels, 2, stride=2)
        self.out = Conv2d(channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        b, r, ph, pw, c = roi_feats.shape
        # the NHWC rois as an NCHW channels_last batch, no copy
        x = roi_feats.reshape(b * r, ph, pw, c).permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = self.out(torch.relu(self.up(x)))
        return x.permute(0, 2, 3, 1).reshape(b, r, ph * 2, pw * 2, -1).to(
            torch.promote_types(x.dtype, torch.float32))


def box_candidates(cls_logits: torch.Tensor, deltas: torch.Tensor,
                   rois: torch.Tensor, image_hw: Tuple[int, int], k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The final NMS's candidates: softmax over the C + 1 logits, every
    (roi, class) pair's box decoded from its deltas and clipped, the top
    ``k`` scores -> (boxes (B, K, 4), scores (B, K), classes (B, K)), K =
    min(k, R * C).

    Pairs are flattened roi-major (roi, then class), as the reference's
    ``tile`` / ``repeat`` are, and the top-k puts the lower index first
    among equal scores, as ``lax.top_k`` does: zero-padded proposals have
    identical features and tie exactly."""
    b, r, c1 = cls_logits.shape
    c = c1 - 1
    probs = torch.softmax(cls_logits, dim=-1)[..., 1:]  # (B, R, C)
    scores = probs.reshape(b, r * c)
    classes = torch.arange(c, device=rois.device).repeat(r)
    roi_rep = rois.repeat_interleave(c, dim=1)
    boxes = decode_deltas(deltas.reshape(b, r * c, 4), roi_rep,
                          stds=BBOX_REG_STDS)
    boxes = clip_boxes(boxes, image_hw[0], image_hw[1])
    top_sc, top_i = topk_lowest_index_first(scores, min(k, r * c))
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    return top_boxes, top_sc, classes[top_i]


def box_head_predict(cls_logits: torch.Tensor, deltas: torch.Tensor,
                     rois: torch.Tensor, image_hw: Tuple[int, int],
                     score_threshold: float = 0.05,
                     nms_threshold: float = 0.5, max_detections: int = 100
                     ) -> Dict[str, torch.Tensor]:
    """``box_candidates`` (the top ``4 * max_detections``), then
    class-aware NMS -> boxes (B, D, 4), scores (B, D), labels (B, D) (-1
    in empty slots, whose box and score are 0), ``nms_passes``."""
    boxes, scores, classes = box_candidates(cls_logits, deltas, rois,
                                            image_hw, max_detections * 4)
    keep, _, passes = batched_nms(boxes, scores, classes, nms_threshold,
                                  score_threshold, max_detections)
    ok = keep >= 0
    sel = keep.clamp(0, boxes.shape[1] - 1)
    out_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
    return {
        "boxes": torch.where(ok[..., None], out_boxes,
                             torch.zeros_like(out_boxes)),
        "scores": torch.where(ok, torch.gather(scores, 1, sel),
                              torch.zeros_like(scores[:, :1])),
        "labels": torch.where(ok, torch.gather(classes, 1, sel),
                              torch.full_like(sel, -1)),
        "nms_passes": passes,
    }


def sample_proposals(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor,
                     proposals: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                     num_samples: int = 256, pos_fraction: float = 0.25,
                     pos_iou: float = 0.5) -> Dict[str, torch.Tensor]:
    """The ROI heads' training set of a batch: proposals (B, K, 4), padded
    GT boxes (B, G, 4), 0-based classes and mask (B, G) -> ``num_samples``
    rois per image and their targets.

    The G GT boxes are appended to the proposals (padded slots too, so
    zero-area candidates take part, as negatives), the N = K + G candidates
    are matched at ``pos_iou`` (no forced matches) and sampled by
    ``sample_balanced`` on the draws ``u1``, ``u2`` (B, N); the chosen ones
    (weight 1) plus ``u3`` (B, N) / 2 rank the candidates, and the top
    ``num_samples`` (the lower index first among equal keys) are the rois.
    Returns rois (B, R, 4), cls_target (B, R) int64 (class + 1, 0 for
    background), delta_target (B, R, 4) (``encode_deltas`` with
    ``BBOX_REG_STDS``), pos_mask and valid_mask (B, R) f32 and matched_gt
    (B, R)."""
    cand = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
    labels, match = match_anchors(cand, gt_boxes, gt_mask, pos_iou, pos_iou,
                                  force_match=False)
    weights = sample_balanced(u1, u2, labels, num_samples, pos_fraction)
    _, sel = topk_lowest_index_first(weights + u3 * 0.5, num_samples)
    rois = take_rows(cand, sel)
    sel_match = torch.gather(match, 1, sel)
    pos = torch.gather(labels, 1, sel) == 1
    cls_target = torch.where(
        pos, torch.gather(gt_classes.long(), 1, sel_match) + 1,
        torch.zeros_like(sel_match))
    delta_target = encode_deltas(take_rows(gt_boxes, sel_match), rois,
                                 stds=BBOX_REG_STDS)
    valid = torch.gather(weights, 1, sel) > 0
    return {"rois": rois, "cls_target": cls_target,
            "delta_target": delta_target,
            "pos_mask": (pos & valid).to(torch.float32),
            "valid_mask": valid.to(torch.float32), "matched_gt": sel_match}


def box_head_loss(cls_logits: torch.Tensor, deltas: torch.Tensor,
                  targets: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of the (B, R, C + 1) logits over the valid rois, and
    smooth L1 (beta 1) of the (B, R, C, 4) deltas of each positive roi's
    own class against its target, each over the count of its rois (at
    least 1) -> (cls_loss, reg_loss)."""
    ct, vm, pm = (targets["cls_target"], targets["valid_mask"],
                  targets["pos_mask"])
    logp = torch.log_softmax(cls_logits, dim=-1)
    cls_loss = -torch.gather(logp, -1, ct[..., None])[..., 0]
    cls_loss = (cls_loss * vm).sum() / vm.sum().clamp(min=1.0)
    cls_idx = (ct - 1).clamp(min=0)
    pd = torch.gather(deltas, 2, cls_idx[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    diff = (pd - targets["delta_target"]).abs()
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    reg_loss = (sl1.sum(-1) * pm).sum() / pm.sum().clamp(min=1.0)
    return cls_loss, reg_loss


def mask_targets(gt_bitmaps: torch.Tensor, targets: Dict[str, torch.Tensor],
                 mask_size: int = 28, stride: int = 1) -> torch.Tensor:
    """Each roi's mask target (B, R, m, m) f32 in {0, 1}: the (B, H / s, W
    / s, G) GT bitmaps cropped with ``roi_align`` (m x m, sampling 2) on
    the rois over ``stride``, every GT channel, then the roi's matched
    channel, above 0.5. On the GPU the crop is one launch of the row-gather
    kernel at C = G in f32."""
    b, r = targets["matched_gt"].shape
    crops = roi_align(gt_bitmaps.to(torch.float32).contiguous(),
                      targets["rois"] / float(stride), (mask_size, mask_size),
                      2)
    idx = targets["matched_gt"][:, :, None, None, None].expand(
        b, r, mask_size, mask_size, 1)
    crops = torch.gather(crops, -1, idx)[..., 0]
    return (crops > 0.5).to(torch.float32)


def mask_head_loss(mask_logits: torch.Tensor, gt_bitmaps: torch.Tensor,
                   targets: Dict[str, torch.Tensor], mask_size: int = 28,
                   stride: int = 1) -> torch.Tensor:
    """Binary cross-entropy of each positive roi's (m, m) mask logits of its
    own class (from (B, R, m, m, C)) against ``mask_targets``, over the
    positive rois' pixels (at least 1)."""
    gt = mask_targets(gt_bitmaps, targets, mask_size, stride)
    cls_idx = (targets["cls_target"] - 1).clamp(min=0)
    b, r = cls_idx.shape
    logits = torch.gather(mask_logits, -1, cls_idx[:, :, None, None, None]
                          .expand(b, r, mask_size, mask_size, 1))[..., 0]
    bce = bce_with_logits(logits, gt)
    pm = targets["pos_mask"][:, :, None, None]
    return (bce * pm).sum() / (pm.sum() * mask_size * mask_size).clamp(
        min=1.0)
