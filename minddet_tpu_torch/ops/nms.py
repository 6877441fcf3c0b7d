"""Greedy rotated NMS on the device (counterpart of the parts of
``minddet_tpu/ops/nms.py`` the PointPillars predict path uses:
``_greedy_keep_from_iou`` and ``rotated_nms``), batched over a leading
sample axis where the reference vmaps one sample at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_bev


def greedy_keep_from_iou(iou: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, iou_threshold: float
                         ) -> Tuple[torch.Tensor, int]:
    """Greedy-NMS keep mask from (B, N, N) IoUs, (B, N) scores and validity.

    The reference's fixed-point iteration: a box is kept iff no earlier
    *kept* box overlaps it above the threshold, where i is earlier than j
    when its score is higher or, at equal scores, its index lower. Each
    pass is one masked (B, N, N) reduction; the loop ends when no sample's
    mask changed (a converged sample stays at its fixed point, so the
    batch gives each sample's own result) or after N passes. The test for
    a change is a host sync on a GPU. Returns (keep (B, N) bool, passes).
    """
    n = iou.shape[-1]
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    idx = torch.arange(n, device=scores.device)
    earlier = (s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :]))
    suppress = ((iou > iou_threshold) & earlier & valid[..., :, None]
                & valid[..., None, :])
    keep = valid
    passes = 0
    while passes < n:
        new_keep = valid & ~(suppress & keep[..., :, None]).any(dim=-2)
        passes += 1
        changed = bool((new_keep != keep).any())
        keep = new_keep
        if not changed:
            break
    return keep, passes


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.1,
                score_threshold: float = float("-inf"),
                max_outputs: int | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy NMS over rotated BEV boxes (B, N, 5) [x, y, w, l, yaw] with
    scores (B, N).

    Returns (indices (B, K) of the kept boxes by descending score, -1
    padded, K = min(max_outputs, N); kept count (B,); the fixed point's
    passes). The IoU matrix is one ``rotated_iou_bev`` call over the batch:
    one K4 launch on the GPU."""
    n = boxes.shape[-2]
    k = n if max_outputs is None else min(max_outputs, n)
    valid = scores > score_threshold
    iou = rotated_iou_bev(boxes, boxes)
    keep, passes = greedy_keep_from_iou(iou, scores, valid, iou_threshold)
    sel = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, idx = topk_lowest_index_first(sel, k)
    idx = torch.where(torch.isfinite(top), idx, torch.full_like(idx, -1))
    return idx, keep.sum(dim=-1, dtype=torch.int32), passes
