"""R-CNN ROI heads for inference (counterpart of ``BoxHead``, ``MaskHead``
and ``box_head_predict`` in ``minddet_tpu/models/heads/roi_head.py``); the
training parts (``sample_proposals``, ``box_head_loss``,
``mask_head_loss``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear
from minddet_tpu_torch.ops.box import clip_boxes, decode_deltas
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import batched_nms

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
