"""Region Proposal Network head and proposal generation (counterpart of
``minddet_tpu/models/heads/rpn_head.py``), batched over images where the
reference vmaps one image at a time.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d
from minddet_tpu_torch.ops.box import clip_boxes, decode_deltas
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import nms


class RPNHead(nn.Module):
    """One shared 3x3 conv + ReLU, then 1x1 objectness (A) and deltas (4A)
    convs, over every level."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3,
                 channels: int = 256):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, padding=1)
        self.cls = Conv2d(channels, num_anchors, 1)
        self.reg = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (objectness (B, A_total), deltas (B, A_total, 4)) in f32 (f64
        for an f64 model), levels concatenated, each level position-major
        (row, column, anchor) as the anchors are."""
        logits, deltas = [], []
        for f in feats:
            x = torch.relu(self.conv(f))
            b = x.shape[0]
            logits.append(self.cls(x).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.reg(x).permute(0, 2, 3, 1).reshape(b, -1, 4))
        out = torch.promote_types(logits[0].dtype, torch.float32)
        return (torch.cat(logits, dim=1).to(out),
                torch.cat(deltas, dim=1).to(out))


def proposal_candidates(logits: torch.Tensor, deltas: torch.Tensor,
                        anchors: torch.Tensor, level_sizes: Sequence[int],
                        image_hw: Tuple[int, int], pre_nms_topk: int = 1000,
                        min_size: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN NMS's candidates: per level the top ``pre_nms_topk`` logits
    (the lower index first among equal ones, as ``lax.top_k``), their
    deltas decoded against their anchors and clipped to the image, levels
    concatenated -> (boxes (B, N, 4), scores (B, N)); a box no wider or
    higher than ``min_size`` scores -inf."""
    ih, iw = image_hw
    cand_boxes, cand_scores = [], []
    start = 0
    for n in level_sizes:
        sc, idx = topk_lowest_index_first(logits[:, start:start + n],
                                          min(pre_nms_topk, n))
        idx = idx + start
        dl = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        cand_boxes.append(decode_deltas(dl, anchors[idx]))
        cand_scores.append(sc)
        start += n
    boxes = clip_boxes(torch.cat(cand_boxes, dim=1), ih, iw)
    scores = torch.cat(cand_scores, dim=1)
    valid = ((boxes[..., 2] - boxes[..., 0] > min_size)
             & (boxes[..., 3] - boxes[..., 1] > min_size))
    return boxes, torch.where(valid, scores,
                              torch.full_like(scores, float("-inf")))


def generate_proposals(logits: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor, level_sizes: Sequence[int],
                       image_hw: Tuple[int, int], pre_nms_topk: int = 1000,
                       post_nms_topk: int = 1000, nms_threshold: float = 0.7,
                       min_size: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """logits (B, A), deltas (B, A, 4), anchors (A, 4), anchors per level ->
    (proposals (B, K, 4), scores (B, K), the NMS's passes), K =
    min(post_nms_topk, candidates): ``proposal_candidates``, then one NMS
    over all levels' candidates. Slots past the last kept box are zero
    boxes with score 0; kept boxes score sigmoid(logit)."""
    boxes, scores = proposal_candidates(logits, deltas, anchors, level_sizes,
                                        image_hw, pre_nms_topk, min_size)
    keep, _, passes = nms(boxes, scores, nms_threshold,
                          max_outputs=post_nms_topk)
    ok = keep >= 0
    sel = keep.clamp(0, boxes.shape[1] - 1)
    props = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
    props = torch.where(ok[..., None], props, torch.zeros_like(props))
    kept_scores = torch.sigmoid(torch.gather(scores, 1, sel))
    kept_scores = torch.where(ok, kept_scores, torch.zeros_like(kept_scores))
    return props, kept_scores, passes
