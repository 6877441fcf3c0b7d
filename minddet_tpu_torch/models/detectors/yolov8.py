"""YOLOv8: C2f backbone, anchor-free DFL head, task-aligned assignment
(counterpart of ``minddet_tpu/models/detectors/yolov8.py``:
``YOLOv8Head``, ``dfl_decode``, ``tal_assign`` and ``YOLOv8`` with
``__call__`` as ``forward``, ``loss`` and ``predict``).

The image is NHWC (B, H, W, 3) as in the reference and is cast to
``dtype``, the compute dtype, once; inside, activations are NCHW in
``channels_last`` memory. The head's outputs are f32 whatever ``dtype``
is, and so are the decode, the assignment and the losses, as in the
reference. No hand-written kernel runs on these paths: convs, BN, SiLU,
max pools, nearest upsampling, a softmax expectation and the axis-aligned
greedy NMS (``ops/nms.py:batched_nms``, one host sync per pass).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import (ConvBlock,
                                                             CSPDarknet)
from minddet_tpu_torch.models.detectors.yolox import (
    CLS_BIAS, best_class_candidates, class_aware_detections, yolo_grid)
from minddet_tpu_torch.models.layers import (Conv2d, DeviceArrays, clip,
                                             init_flax_defaults_, take_rows)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.models.necks.pan import C2fPAN
from minddet_tpu_torch.ops.box import elementwise_iou, pairwise_iou

REG_MAX = 16  # DFL bins per side
# the loss weights of the reference: box IoU, class BCE, DFL
IOU_WEIGHT, CLS_WEIGHT, DFL_WEIGHT = 7.5, 0.5, 1.5


class YOLOv8Head(nn.Module):
    """Decoupled DFL head with ultralytics' branch widths: ``reg{i}_0``,
    ``reg{i}_1`` at ``max(16, width / 4, 4 REG_MAX)`` into ``reg_out{i}``
    (4 REG_MAX logits), ``cls{i}_0``, ``cls{i}_1`` at ``max(width,
    min(num_classes, 100))`` into ``cls_out{i}`` (bias ``CLS_BIAS`` at
    init), for each level i of ``in_channels``; ``width`` is P3's."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 width: int = 128):
        super().__init__()
        self.num_classes = num_classes
        self.levels = len(in_channels)
        w_reg = max(16, width // 4, 4 * REG_MAX)
        w_cls = max(width, min(num_classes, 100))
        for i, c in enumerate(in_channels):
            self.add_module(f"reg{i}_0", ConvBlock(c, w_reg, 3))
            self.add_module(f"reg{i}_1", ConvBlock(w_reg, w_reg, 3))
            self.add_module(f"reg_out{i}", Conv2d(w_reg, 4 * REG_MAX, 1))
            self.add_module(f"cls{i}_0", ConvBlock(c, w_cls, 3))
            self.add_module(f"cls{i}_1", ConvBlock(w_cls, w_cls, 3))
            self.add_module(f"cls_out{i}", Conv2d(w_cls, num_classes, 1))

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> DFL logits (B, A, 4, REG_MAX), class logits (B, A, C), both
        f32, the levels' positions row-major one level after another."""
        dfls, clss = [], []
        for i, f in enumerate(feats):
            b = f.shape[0]
            r, c = f, f
            for j in range(2):
                r = getattr(self, f"reg{i}_{j}")(r)
                c = getattr(self, f"cls{i}_{j}")(c)
            dfls.append(getattr(self, f"reg_out{i}")(r).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4, REG_MAX))
            clss.append(getattr(self, f"cls_out{i}")(c).permute(0, 2, 3, 1)
                        .reshape(b, -1, self.num_classes))
        return torch.cat(dfls, 1).float(), torch.cat(clss, 1).float()


def dfl_decode(dfl_logits: torch.Tensor, points: torch.Tensor,
               strides: torch.Tensor) -> torch.Tensor:
    """DFL logits (..., A, 4, REG_MAX) -> each side's softmax expectation
    over the bins 0..REG_MAX-1 (left, top, right, bottom distances in
    strides) -> corner boxes (..., A, 4) around ``points`` (..., A, 2)."""
    bins = torch.arange(REG_MAX, dtype=dfl_logits.dtype,
                        device=dfl_logits.device)
    dist = (torch.softmax(dfl_logits, -1) * bins).sum(-1)
    d = dist * strides[..., None]
    return torch.stack([points[..., 0] - d[..., 0], points[..., 1] - d[..., 1],
                        points[..., 0] + d[..., 2], points[..., 1] + d[..., 3]],
                       -1)


def align_metric(boxes: torch.Tensor, cls_logits: torch.Tensor,
                 points: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                 alpha: float = 0.5, beta: float = 6.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The task-aligned metric of ``tal_assign`` (same arguments): (B, G,
    A) sigmoid(class logit of the GT's class)^alpha * IoU^beta, each
    clipped into [1e-8, 1] first, 0 where the anchor's point lies outside
    the GT or the slot is padding (the IoU's power underflows to 0 in f32
    near the clip); and the (B, G, A) IoUs, 0 at padding."""
    a = boxes.shape[1]
    px, py = points[:, 0], points[:, 1]
    in_box = ((px >= gt_boxes[..., 0:1]) & (px <= gt_boxes[..., 2:3])
              & (py >= gt_boxes[..., 1:2]) & (py <= gt_boxes[..., 3:4])
              & gt_mask[..., None])
    iou = torch.where(gt_mask[..., None], pairwise_iou(gt_boxes, boxes),
                      torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    cls_p = torch.sigmoid(cls_logits)
    cls_idx = torch.where(gt_mask, gt_classes, torch.zeros_like(gt_classes))
    gt_p = torch.gather(cls_p, 2, cls_idx[:, None, :].expand(
        -1, a, -1).long()).transpose(1, 2)
    metric = (torch.pow(clip(gt_p, 1e-8, 1.0), alpha)
              * torch.pow(clip(iou, 1e-8, 1.0), beta))
    return torch.where(in_box, metric, torch.zeros_like(metric)), iou


def tal_assign(boxes: torch.Tensor, cls_logits: torch.Tensor,
               points: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_mask: torch.Tensor,
               topk: int = 10, alpha: float = 0.5, beta: float = 6.0
               ) -> Dict[str, torch.Tensor]:
    """Task-aligned assignment, batched over B as the reference ``vmap``s
    its one-image function: decoded boxes (B, A, 4), class logits (B, A,
    C), anchor points (A, 2), ground truth (B, G, 4) / (B, G) / (B, G) ->
    fg (B, A) bool, matched_gt (B, A) and soft_target (B, A).

    An anchor is matched to a GT when its ``align_metric`` is positive and
    ranks among the GT's ``topk`` (a stable sort: the lower anchor first
    among equal metrics), and takes the matched GT of the largest metric
    (the first such GT at a tie). The soft target is that metric over the
    GT's largest, times the largest IoU among the GT's matched anchors.
    Nothing is detached: the soft target carries gradient into the class
    logits and the boxes, as in the reference."""
    metric, iou = align_metric(boxes, cls_logits, points, gt_boxes,
                               gt_classes, gt_mask, alpha, beta)
    order = torch.argsort(-metric, dim=2, stable=True)
    rank = torch.argsort(order, dim=2)
    matched = (rank < topk) & (metric > 0)
    best_gt = torch.argmax(torch.where(matched, metric,
                                       torch.full_like(metric, -1.0)), dim=1)
    # amax splits a tie's gradient evenly, as jnp.max does
    m_max = metric.amax(dim=2, keepdim=True)
    i_max = torch.where(matched, iou, torch.zeros_like(iou)).amax(
        dim=2, keepdim=True)
    norm = metric / torch.maximum(m_max, torch.full_like(m_max, 1e-8)) * i_max
    return {"fg": matched.any(dim=1), "matched_gt": best_gt,
            "soft_target": torch.gather(norm, 1, best_gt[:, None])[:, 0]}


class YOLOv8(nn.Module):
    """YOLOv8-s by default: ``CSPDarknet(use_c2f=True)``, ``C2fPAN`` at
    (w, 2 w, 4 w) with w = 256 scaled by ``width_mult`` and depth 3 scaled
    by ``depth_mult``, ``YOLOv8Head`` at width w."""

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (640, 640),
                 depth_mult: float = 0.33, width_mult: float = 0.5,
                 strides: Sequence[int] = (8, 16, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.image_hw = tuple(image_hw)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.backbone = CSPDarknet(depth_mult, width_mult, use_c2f=True)
        w = max(16, int(256 * width_mult // 8 * 8))
        self.neck = C2fPAN(self.backbone.out_channels, (w, 2 * w, 4 * w),
                           max(1, round(3 * depth_mult)))
        self.head = YOLOv8Head((w, 2 * w, 4 * w), num_classes, width=w)
        # grid(device): the anchor points (A, 2) and strides (A,), f32
        self.grid = DeviceArrays(*yolo_grid(self.image_hw, self.strides))

    def features(self, image: torch.Tensor):
        """image (B, H, W, 3) -> ((C3, C4, C5), (N3, N4, N5)), NCHW maps in
        ``dtype``."""
        feats = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        return feats, self.neck(feats)

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) -> DFL logits (B, A, 4, REG_MAX) and class
        logits (B, A, C), f32. BN as the module's mode says."""
        return self.head(self.features(image)[1])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch: image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G) bool.
        Over the foreground of ``tal_assign``, each term normalised by the
        soft targets' sum (at least 1): the BCE of the class logits against
        the one-hot class times the soft target, the boxes' (1 - IoU) and
        the DFL cross-entropy against the two bins around each side's
        distance, these two weighted by the soft target. Returns (7.5 iou +
        0.5 cls + 1.5 dfl, {iou_loss, cls_loss, dfl_loss})."""
        dfl, cls = self(batch["image"])
        points, strides = self.grid(dfl.device)
        boxes = dfl_decode(dfl, points[None], strides[None])
        gt_boxes, gt_classes = batch["gt_boxes"], batch["gt_classes"]
        assign = tal_assign(boxes, cls, points, gt_boxes, gt_classes,
                            batch["gt_mask"])
        w = assign["soft_target"] * assign["fg"].to(boxes.dtype)
        num_fg = torch.maximum(w.sum(), torch.ones_like(w[0, 0]))

        mg = assign["matched_gt"]
        tgt_cls = F.one_hot(torch.gather(gt_classes.long(), 1, mg),
                            self.num_classes).to(cls.dtype) * w[..., None]
        cls_loss = bce_with_logits(cls, tgt_cls).sum() / num_fg

        gt_pa = take_rows(gt_boxes, mg)
        iou_loss = ((1.0 - elementwise_iou(boxes, gt_pa)) * w).sum() / num_fg

        px, py = points[None, :, 0], points[None, :, 1]
        d_target = torch.stack([px - gt_pa[..., 0], py - gt_pa[..., 1],
                                gt_pa[..., 2] - px, gt_pa[..., 3] - py],
                               -1) / strides[None, :, None]
        d_target = d_target.clamp(0, REG_MAX - 1 - 1e-3)
        lo = torch.floor(d_target)
        w_hi = d_target - lo
        logp = torch.log_softmax(dfl, -1)
        lo_i = lo.long()[..., None]
        ce = -(torch.gather(logp, -1, lo_i)[..., 0] * (1 - w_hi)
               + torch.gather(logp, -1, lo_i + 1)[..., 0] * w_hi)
        dfl_loss = (ce.mean(-1) * w).sum() / num_fg

        total = (IOU_WEIGHT * iou_loss + CLS_WEIGHT * cls_loss
                 + DFL_WEIGHT * dfl_loss)
        return total, {"iou_loss": iou_loss, "cls_loss": cls_loss,
                       "dfl_loss": dfl_loss}

    def candidates(self, dfl: torch.Tensor, cls: torch.Tensor,
                   pre_nms: int = 1000) -> Dict[str, torch.Tensor]:
        """``best_class_candidates`` of the decoded boxes, each class scored
        by the sigmoid of its logit."""
        points, strides = self.grid(dfl.device)
        boxes = dfl_decode(dfl, points[None], strides[None])
        return best_class_candidates(boxes, torch.sigmoid(cls), pre_nms)

    def detections(self, cand: Dict[str, torch.Tensor],
                   score_threshold: float = 0.01, nms_threshold: float = 0.7,
                   max_detections: int = 100) -> Dict:
        """``class_aware_detections`` at YOLOv8's thresholds."""
        return class_aware_detections(cand, score_threshold, nms_threshold,
                                      max_detections)

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, score_threshold: float = 0.01,
                nms_threshold: float = 0.7, max_detections: int = 100,
                pre_nms: int = 1000) -> Dict:
        """image (B, H, W, 3) -> ``detections`` of the ``pre_nms``
        ``candidates``: boxes (B, 100, 4) in input pixels, scores, labels,
        ``nms_passes``."""
        dfl, cls = self(image)
        return self.detections(self.candidates(dfl, cls, pre_nms),
                               score_threshold, nms_threshold,
                               max_detections)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YOLOv8":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN), the class
        convs' biases at ``CLS_BIAS``."""
        init_flax_defaults_(self, generator)
        for i in range(self.head.levels):
            nn.init.constant_(getattr(self.head, f"cls_out{i}").bias,
                              CLS_BIAS)
        return self
