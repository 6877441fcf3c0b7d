"""YOLOX: anchor-free decoupled head with SimOTA assignment (counterpart of
``minddet_tpu/models/detectors/yolox.py``: ``yolo_grid``, ``YOLOXHead``,
``decode_yolox``, ``simota_assign`` and ``YOLOX`` with ``__call__`` as
``forward``, ``loss`` and ``predict``; its ``_bce`` is
``models/losses.py:bce_with_logits``), and the top-k plus class-aware
NMS that every YOLO ``predict`` shares.

The image is NHWC (B, H, W, 3) as in the reference and is cast to
``dtype``, the compute dtype, once; inside, activations are NCHW in
``channels_last`` memory. The head's outputs are f32 whatever ``dtype`` is,
and so are the decode, the assignment and the losses, as in the reference.
No hand-written kernel runs on these paths: convs, BN, SiLU, max pools,
nearest upsampling, sigmoids, an exp and the axis-aligned greedy NMS
(``ops/nms.py:batched_nms``, one host sync per pass).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import (ConvBlock,
                                                             CSPDarknet)
from minddet_tpu_torch.models.layers import (Conv2d, DeviceArrays, clip,
                                             init_flax_defaults_, take_rows)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.models.necks.pan import PAN
from minddet_tpu_torch.ops.box import elementwise_iou, pairwise_iou
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import batched_nms

CLS_BIAS = -4.59  # the class and objectness convs' initial bias: sigmoid ~0.01
IOU_WEIGHT = 5.0  # the IoU loss's weight; objectness and class weigh 1
STRIDES = (8, 16, 32)
CENTER_RADIUS = 2.5  # SimOTA's centre region: this many strides around a GT
TOPK_IOUS = 10  # SimOTA's k: the sum of a GT's top TOPK_IOUS candidate IoUs


def yolo_grid(image_hw: Tuple[int, int], strides: Sequence[int] = (8, 16, 32)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The anchor points of every level, concatenated: centres (A, 2) xy in
    pixels, ((x + 0.5) s, (y + 0.5) s) row-major, and strides (A,), both
    f32."""
    pts, sts = [], []
    ih, iw = image_hw
    for s in strides:
        fh, fw = ih // s, iw // s
        ys, xs = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
        p = np.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2)
        pts.append(p.astype(np.float32))
        sts.append(np.full((len(p),), s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)


def best_class_candidates(boxes: torch.Tensor, class_scores: torch.Tensor,
                          pre_nms: int = 1000) -> Dict[str, torch.Tensor]:
    """Decoded boxes (B, A, 4) and per-class scores (B, A, C) -> the
    ``pre_nms`` anchors of each image with the best scores (each anchor's
    best class; the lower anchor first among equal scores): scores (B, K),
    boxes (B, K, 4), labels (B, K) (the first best class), anchor index
    (B, K); K = min(pre_nms, A)."""
    scores, labels = class_scores.max(dim=-1)
    top_s, top_i = topk_lowest_index_first(scores,
                                           min(pre_nms, scores.shape[1]))
    return {"scores": top_s, "boxes": take_rows(boxes, top_i),
            "labels": torch.gather(labels, 1, top_i), "index": top_i}


def class_aware_detections(cand: Dict[str, torch.Tensor],
                           score_threshold: float, nms_threshold: float,
                           max_detections: int = 100) -> Dict:
    """Class-aware NMS of ``best_class_candidates`` over
    ``score_threshold``: boxes (B, D, 4), scores (B, D), labels (B, D)
    int32 (0, 0 and -1 in empty slots), ``nms_passes``; D =
    min(max_detections, K)."""
    k = cand["scores"].shape[1]
    keep, _, passes = batched_nms(cand["boxes"], cand["scores"],
                                  cand["labels"], nms_threshold,
                                  score_threshold, max_detections)
    sel = keep.clamp(0, k - 1)
    ok = keep >= 0
    labels = torch.gather(cand["labels"], 1, sel).to(torch.int32)
    return {"boxes": torch.where(ok[..., None], take_rows(cand["boxes"], sel),
                                 0.0),
            "scores": torch.where(ok, torch.gather(cand["scores"], 1, sel),
                                  0.0),
            "labels": torch.where(ok, labels, -1),
            "nms_passes": passes}


class YOLOXHead(nn.Module):
    """Decoupled head at ``width``: per level i of ``in_channels`` a 1x1
    ``stem{i}``, then two 3x3 ConvBlocks ``cls{i}_0``, ``cls{i}_1`` into
    ``cls_out{i}`` (C logits) and two ``reg{i}_0``, ``reg{i}_1`` into
    ``reg_out{i}`` (4 box offsets) and ``obj_out{i}`` (1 objectness
    logit), 1x1 convs with biases."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 width: int = 128):
        super().__init__()
        self.num_classes = num_classes
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"stem{i}", ConvBlock(c, width, 1))
            for j in range(2):
                self.add_module(f"cls{i}_{j}", ConvBlock(width, width, 3))
                self.add_module(f"reg{i}_{j}", ConvBlock(width, width, 3))
            self.add_module(f"cls_out{i}", Conv2d(width, num_classes, 1))
            self.add_module(f"reg_out{i}", Conv2d(width, 4, 1))
            self.add_module(f"obj_out{i}", Conv2d(width, 1, 1))

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> raw box offsets (B, A, 4), objectness logits (B, A), class
        logits (B, A, C), all f32, the levels' positions row-major one level
        after another."""
        regs, objs, clss = [], [], []
        for i, f in enumerate(feats):
            b = f.shape[0]
            x = getattr(self, f"stem{i}")(f)
            c, r = x, x
            for j in range(2):
                c = getattr(self, f"cls{i}_{j}")(c)
                r = getattr(self, f"reg{i}_{j}")(r)
            clss.append(getattr(self, f"cls_out{i}")(c).permute(0, 2, 3, 1)
                        .reshape(b, -1, self.num_classes))
            regs.append(getattr(self, f"reg_out{i}")(r).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4))
            objs.append(getattr(self, f"obj_out{i}")(r).reshape(b, -1))
        return (torch.cat(regs, 1).float(), torch.cat(objs, 1).float(),
                torch.cat(clss, 1).float())


def decode_yolox(reg: torch.Tensor, points: torch.Tensor,
                 strides: torch.Tensor) -> torch.Tensor:
    """Raw offsets (..., A, 4) -> corner boxes (..., A, 4): centre = point +
    offset * stride, size = exp(offset clipped into [-10, 8]) * stride."""
    xy = points + reg[..., :2] * strides[..., None]
    wh = torch.exp(clip(reg[..., 2:], -10.0, 8.0)) * strides[..., None]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def simota_cost(boxes: torch.Tensor, obj_logits: torch.Tensor,
                cls_logits: torch.Tensor, points: torch.Tensor,
                strides: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SimOTA's pairwise terms (arguments as ``simota_assign``'s): the cost
    (B, G, A), the candidate mask (B, G, A) and the IoUs (B, G, A), 0 at
    padding.

    A (GT, anchor) pair is a candidate where the anchor's point lies in the
    GT box or within CENTER_RADIUS strides of its centre (and the slot
    is no padding), strong where both. Its cost is -log sqrt(p_cls(GT's
    class) p_obj) + 3 (-log IoU), both clipped into [1e-8, 1] first, plus
    1e5 where not a candidate and 1e4 where not strong."""
    a = boxes.shape[1]
    px, py = points[:, 0], points[:, 1]
    x1, y1, x2, y2 = (gt_boxes[..., k:k + 1] for k in range(4))
    in_box = (px >= x1) & (px <= x2) & (py >= y1) & (py <= y2)
    gcx = (x1 + x2) / 2
    gcy = (y1 + y2) / 2
    r = CENTER_RADIUS * strides
    in_center = ((px >= gcx - r) & (px <= gcx + r)
                 & (py >= gcy - r) & (py <= gcy + r))
    real = gt_mask[..., None]
    cand = (in_box | in_center) & real
    strong = in_box & in_center
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    iou = torch.where(real, pairwise_iou(gt_boxes, boxes), zero)

    cls_idx = torch.where(gt_mask, gt_classes,
                          torch.zeros_like(gt_classes)).long()
    gt_cls_p = torch.gather(torch.sigmoid(cls_logits), 2, cls_idx[:, None, :]
                            .expand(-1, a, -1)).transpose(1, 2)
    score = torch.sqrt(clip(gt_cls_p * torch.sigmoid(obj_logits)[:, None],
                            1e-8, 1.0))
    cost = (-torch.log(score) + 3.0 * -torch.log(clip(iou, 1e-8, 1.0))
            + 1e5 * (~cand).to(iou.dtype) + 1e4 * (~strong).to(iou.dtype))
    return cost, cand, iou


def simota_assign(boxes: torch.Tensor, obj_logits: torch.Tensor,
                  cls_logits: torch.Tensor, points: torch.Tensor,
                  strides: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_mask: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """SimOTA, batched over B as the reference ``vmap``s its one-image
    function: decoded boxes (B, A, 4), objectness logits (B, A), class
    logits (B, A, C), anchor points (A, 2) and strides (A,), ground truth
    (B, G, 4) / (B, G) / (B, G) -> fg (B, A) bool, matched_gt (B, A) and
    matched_iou (B, A).

    Each GT takes its k cheapest candidates of ``simota_cost`` (a stable
    sort: the lower anchor first among equal costs), k the sum of its top
    TOPK_IOUS candidate IoUs truncated and clipped into [1, TOPK_IOUS] (0
    for padding); an anchor taken by several keeps the
    cheapest (the first such GT at a tie; an anchor no GT took reports GT
    0). Nothing is detached: the matched IoU carries gradient into the
    boxes, as in the reference."""
    a = boxes.shape[1]
    cost, cand, iou = simota_cost(boxes, obj_logits, cls_logits, points,
                                  strides, gt_boxes, gt_classes, gt_mask)
    zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
    k_iou = torch.where(cand, iou, zero).topk(min(TOPK_IOUS, a), dim=2).values
    dyn_k = k_iou.sum(2).to(torch.int32).clamp(1, TOPK_IOUS)
    dyn_k = torch.where(gt_mask, dyn_k, torch.zeros_like(dyn_k))

    order = torch.argsort(cost, dim=2, stable=True)
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(a, device=order.device).expand_as(order))
    matched = (rank < dyn_k[..., None]) & cand
    best_gt = torch.where(matched, cost,
                          torch.full_like(cost, float("inf"))).argmin(dim=1)
    return {"fg": matched.any(dim=1), "matched_gt": best_gt,
            "matched_iou": torch.gather(iou, 1, best_gt[:, None])[:, 0]}


class YOLOX(nn.Module):
    """YOLOX-s by default: ``CSPDarknet`` (CSP blocks), ``PAN`` at (w, 2 w,
    4 w) with w = 256 scaled by ``width_mult`` and depth 3 scaled by
    ``depth_mult``, ``YOLOXHead`` at width w."""

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (640, 640),
                 depth_mult: float = 0.33, width_mult: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.image_hw = tuple(image_hw)
        self.dtype = dtype
        self.backbone = CSPDarknet(depth_mult, width_mult)
        w = max(16, int(256 * width_mult // 8 * 8))
        self.neck = PAN(self.backbone.out_channels, (w, 2 * w, 4 * w),
                        max(1, round(3 * depth_mult)))
        self.head = YOLOXHead((w, 2 * w, 4 * w), num_classes, width=w)
        self.grid = DeviceArrays(*yolo_grid(self.image_hw, STRIDES))

    def features(self, image: torch.Tensor):
        """image (B, H, W, 3) -> ((C3, C4, C5), (N3, N4, N5)), NCHW maps in
        ``dtype``."""
        feats = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        return feats, self.neck(feats)

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) -> raw box offsets (B, A, 4), objectness
        logits (B, A) and class logits (B, A, C), f32. BN as the module's
        mode says."""
        return self.head(self.features(image)[1])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch: image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G) bool.
        With ``simota_assign``'s foreground, each term over its count (at
        least 1): the objectness BCE against the foreground at every
        anchor, the class BCE against the one-hot class times the matched
        IoU and 1 - IoU² of the boxes, both over the foreground. Returns
        (5 iou + obj + cls, {iou_loss, obj_loss, cls_loss})."""
        reg, obj, cls = self(batch["image"])
        points, strides = self.grid(reg.device)
        boxes = decode_yolox(reg, points[None], strides[None])
        gt_boxes, gt_classes = batch["gt_boxes"], batch["gt_classes"]
        assign = simota_assign(boxes, obj, cls, points, strides, gt_boxes,
                               gt_classes, batch["gt_mask"])
        fg = assign["fg"].to(boxes.dtype)
        total_fg = fg.sum()
        num_fg = torch.maximum(total_fg, torch.ones_like(total_fg))
        obj_loss = bce_with_logits(obj, fg).sum() / num_fg

        mg = assign["matched_gt"]
        tgt_cls = F.one_hot(torch.gather(gt_classes.long(), 1, mg),
                            self.num_classes).to(cls.dtype)
        tgt_cls = tgt_cls * assign["matched_iou"][..., None]
        cls_loss = (bce_with_logits(cls, tgt_cls) * fg[..., None]).sum() \
            / num_fg
        iou = elementwise_iou(boxes, take_rows(gt_boxes, mg))
        iou_loss = ((1.0 - iou ** 2) * fg).sum() / num_fg
        total = IOU_WEIGHT * iou_loss + obj_loss + cls_loss
        return total, {"iou_loss": iou_loss, "obj_loss": obj_loss,
                       "cls_loss": cls_loss}

    def candidates(self, reg: torch.Tensor, obj: torch.Tensor,
                   cls: torch.Tensor, pre_nms: int = 1000
                   ) -> Dict[str, torch.Tensor]:
        """``best_class_candidates`` of the decoded boxes, each class scored
        sigmoid(class logit) x sigmoid(objectness)."""
        points, strides = self.grid(reg.device)
        boxes = decode_yolox(reg, points[None], strides[None])
        scores = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
        return best_class_candidates(boxes, scores, pre_nms)

    def detections(self, cand: Dict[str, torch.Tensor],
                   score_threshold: float = 0.01, nms_threshold: float = 0.65,
                   max_detections: int = 100) -> Dict:
        """``class_aware_detections`` at YOLOX's thresholds."""
        return class_aware_detections(cand, score_threshold, nms_threshold,
                                      max_detections)

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, score_threshold: float = 0.01,
                nms_threshold: float = 0.65, max_detections: int = 100,
                pre_nms: int = 1000) -> Dict:
        """image (B, H, W, 3) -> ``detections`` of the ``pre_nms``
        ``candidates``: boxes (B, 100, 4) in input pixels, scores, labels,
        ``nms_passes``."""
        return self.detections(self.candidates(*self(image),
                                               pre_nms=pre_nms),
                               score_threshold, nms_threshold, max_detections)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YOLOX":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN), the class
        and objectness convs' biases at ``CLS_BIAS``."""
        init_flax_defaults_(self, generator)
        for i in range(self.head.levels):
            for name in (f"cls_out{i}", f"obj_out{i}"):
                nn.init.constant_(getattr(self.head, name).bias, CLS_BIAS)
        return self
