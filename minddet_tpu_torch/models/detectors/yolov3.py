"""YOLOv3: Darknet-53 and the anchor-based three-level head (counterpart of
``minddet_tpu/models/detectors/yolov3.py``: ``YOLOV3_ANCHORS``,
``_DarkConv`` as ``DarkConv``, ``_Residual`` as ``DarkResidual``,
``Darknet53`` and ``YOLOv3`` with ``__call__`` as ``forward``,
``_decode_level``, ``loss`` and ``predict``; the loss's one-image
``level_targets`` and ``ignore`` are ``yolov3_targets`` and
``ignore_mask`` here, batched).

The image is NHWC (B, H, W, 3) and is cast to ``dtype``, the compute
dtype, once; inside, activations are NCHW in ``channels_last`` memory. The
levels come in stride order 32, 16, 8 (not ``AnchorYOLO``'s 8, 16, 32),
each (B, H, W, na, 5 + C) f32 whatever ``dtype`` is, and so are the
decode, the targets and the losses. Every BN is flax's
``BatchNorm(momentum=0.9)`` at eps 1e-5 (torch momentum 0.1). No
hand-written kernel runs on these paths: convs, BN, leaky ReLU, nearest
upsampling, sigmoids, an exp and the axis-aligned greedy NMS.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.detectors.yolov5 import decode_anchor_level
from minddet_tpu_torch.models.detectors.yolox import (best_class_candidates,
                                                      class_aware_detections)
from minddet_tpu_torch.models.layers import (BN_EPS, BatchNorm, Conv2d,
                                             DeviceArrays,
                                             init_flax_defaults_, take_rows)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.models.necks.pan import up2
from minddet_tpu_torch.ops.box import elementwise_iou, pairwise_iou

# COCO anchors (w, h) pixels, per level of stride 32 / 16 / 8
YOLOV3_ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),
    ((30, 61), (62, 45), (59, 119)),
    ((10, 13), (16, 30), (33, 23)),
)
STRIDES = (32, 16, 8)
BN_MOMENTUM = 0.1  # flax's 0.9
BOX_WEIGHT = 2.0  # the box loss's weight; objectness and class weigh 1
IGNORE_IOU = 0.5  # a prediction over this IoU with a GT is no negative


class DarkConv(nn.Module):
    """conv (no bias, padding kernel // 2) -> BN -> leaky ReLU (0.1)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride=strides,
                           padding=kernel // 2, bias=False)
        self.bn = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class DarkResidual(nn.Module):
    """x + ``c2``(``c1``(x)): a 1x1 to half the width, a 3x3 back."""

    def __init__(self, features: int):
        super().__init__()
        self.c1 = DarkConv(features, features // 2, 1)
        self.c2 = DarkConv(features // 2, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.c1(x))


class Darknet53(nn.Module):
    """The 3x3 ``stem`` (32), then five stages of a 3x3 stride-2
    ``down{s}`` and ``res{s}_{i}`` residuals, (64, 1), (128, 2), (256, 8),
    (512, 8), (1024, 4). Returns (C3, C4, C5) at strides 8, 16 and 32."""

    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self):
        super().__init__()
        self.stem = DarkConv(3, 32, 3)
        cin = 32
        for si, (c, n) in enumerate(self.STAGES):
            self.add_module(f"down{si}", DarkConv(cin, c, 3, 2))
            for i in range(n):
                self.add_module(f"res{si}_{i}", DarkResidual(c))
            cin = c
        self.out_channels = (256, 512, 1024)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        outs = []
        for si, (_, n) in enumerate(self.STAGES):
            x = getattr(self, f"down{si}")(x)
            for i in range(n):
                x = getattr(self, f"res{si}_{i}")(x)
            outs.append(x)
        return outs[2], outs[3], outs[4]


def best_anchor(gt_boxes: torch.Tensor, anchors_wh: torch.Tensor
                ) -> torch.Tensor:
    """Each GT's (B, G, 4) best anchor shape of ``anchors_wh`` (K, 2) by the
    IoU of the two sizes set on one corner, the union kept above 1e-8: (B,
    G) int64, the first of the best (as ``jnp.argmax``)."""
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    aw, ah = anchors_wh[:, 0], anchors_wh[:, 1]
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    return torch.argmax(inter / union.clamp(min=1e-8), dim=-1)


def yolov3_targets(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                   gt_mask: torch.Tensor, best: torch.Tensor, level: int,
                   stride: float, hw: Tuple[int, int], na: int = 3
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Level ``level``'s target maps (the reference's ``level_targets``,
    batched): ground truth (B, G, 4) xyxy pixels / (B, G) classes / (B, G)
    mask, each GT's ``best_anchor`` of the nine (B, G) -> pos (B, h w na)
    {0, 1} in the boxes' dtype, tbox (B, h w na, 4) the GT's box, tcls (B,
    h w na) int32 its class, flattened over (h, w, na).

    A valid GT whose best anchor lies on this level (best // na == level)
    claims slot (its centre's cell, best % na): the centre in cells,
    clipped into [0, w - 1e-3] and truncated. Where two claim one slot the
    later GT wins, as the reference's ``.at[].set`` does on the CPU (a
    ``scatter_reduce`` of the writers' positions by max, so that the rule
    holds on the GPU too); the other GTs go to a dropped overflow slot."""
    h, w = hw
    slots = h * w * na
    on_level = (torch.div(best, na, rounding_mode="floor") == level) \
        & gt_mask
    cx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2 / stride).clamp(
        0, w - 1e-3)
    cy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2 / stride).clamp(
        0, h - 1e-3)
    cell = (cy.to(torch.int32).long() * (w * na)
            + cx.to(torch.int32).long() * na + best % na)
    cell = torch.where(on_level, cell, torch.full_like(cell, slots))
    writer = torch.arange(cell.shape[1], device=cell.device).expand_as(cell)
    last = torch.full((cell.shape[0], slots + 1), -1, dtype=torch.long,
                      device=cell.device).scatter_reduce(
                          1, cell, writer, "amax")[:, :slots]
    pos = last >= 0
    gt_of = last.clamp(min=0)
    tbox = torch.where(pos[..., None], take_rows(gt_boxes, gt_of),
                       torch.zeros((), dtype=gt_boxes.dtype,
                                   device=gt_boxes.device))
    tcls = torch.where(pos, torch.gather(gt_classes, 1, gt_of),
                       torch.zeros_like(gt_of, dtype=gt_classes.dtype))
    return pos.to(gt_boxes.dtype), tbox, tcls.to(torch.int32)


def ignore_mask(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                gt_mask: torch.Tensor, threshold: float) -> torch.Tensor:
    """Decoded boxes (B, N, 4) whose largest IoU with a valid GT (B, G, 4)
    lies strictly above ``threshold`` (masked GTs read 0): (B, N) bool."""
    iou = pairwise_iou(boxes, gt_boxes)
    iou = torch.where(gt_mask[:, None, :], iou, torch.zeros_like(iou))
    return iou.amax(dim=-1) > threshold


class YOLOv3(nn.Module):
    """``Darknet53`` and three head blocks. A block at width c over its
    input: ``{h}_a{i}`` 1x1 to c and ``{h}_b{i}`` 3x3 to 2 c twice,
    ``{h}_mid`` 1x1 to c (the route onward), ``{h}_pre`` 3x3 to 2 c and the
    1x1 ``{h}_out`` with a bias to 3 (5 + C). ``h5`` (512) on C5;
    ``route5`` 1x1 to 256, upsampled x2 and concatenated before C4 into
    ``h4`` (256); ``route4`` to 128, the same with C3 into ``h3`` (128).
    The loss: each GT on its best anchor shape's level (``yolov3_targets``),
    the objectness BCE over the positives and the negatives outside the
    ``ignore_mask``, 1 - IoU over the positives, the class BCE over the
    positives, each over the batch's positives on the level (at least 1)."""

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (416, 416),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.image_hw = tuple(image_hw)
        self.dtype = dtype
        self.anchors = YOLOV3_ANCHORS
        self.backbone = Darknet53()
        c3, c4, c5 = self.backbone.out_channels
        self._block("h5", c5, 512)
        self.route5 = DarkConv(512, 256, 1)
        self._block("h4", 256 + c4, 256)
        self.route4 = DarkConv(256, 128, 1)
        self._block("h3", 128 + c3, 128)
        # anchor_wh[l](device): level l's anchor widths and heights (3, 2);
        # all_anchor_wh(device): the nine of them, level after level; f32
        self.anchor_wh = [DeviceArrays(np.asarray(lv, np.float32))
                          for lv in YOLOV3_ANCHORS]
        self.all_anchor_wh = DeviceArrays(np.asarray(
            [a for lv in YOLOV3_ANCHORS for a in lv], np.float32))

    def _block(self, name: str, cin: int, c: int) -> None:
        for i in range(2):
            self.add_module(f"{name}_a{i}", DarkConv(cin, c, 1))
            self.add_module(f"{name}_b{i}", DarkConv(c, 2 * c, 3))
            cin = 2 * c
        self.add_module(f"{name}_mid", DarkConv(2 * c, c, 1))
        self.add_module(f"{name}_pre", DarkConv(c, 2 * c, 3))
        self.add_module(f"{name}_out",
                        Conv2d(2 * c, 3 * (5 + self.num_classes), 1))

    def _run_block(self, name: str, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(2):
            x = getattr(self, f"{name}_b{i}")(getattr(self, f"{name}_a{i}")(x))
        x = getattr(self, f"{name}_mid")(x)
        out = getattr(self, f"{name}_out")(getattr(self, f"{name}_pre")(x))
        return x, out

    def features(self, image: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) -> (C3, C4, C5), NCHW maps in ``dtype``."""
        return self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))

    def heads(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """(C3, C4, C5) -> the head outputs of strides 32, 16 and 8, each
        (B, H, W, 3, 5 + C) f32."""
        c3, c4, c5 = feats
        x, o5 = self._run_block("h5", c5)
        x, o4 = self._run_block("h4", torch.cat([up2(self.route5(x)), c4],
                                                dim=1))
        _, o3 = self._run_block("h3", torch.cat([up2(self.route4(x)), c3],
                                                dim=1))
        outs = []
        for o in (o5, o4, o3):
            o = o.permute(0, 2, 3, 1)
            b, h, w, _ = o.shape
            outs.append(o.reshape(b, h, w, 3, 5 + self.num_classes).float())
        return outs

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image (B, H, W, 3) -> ``heads``' three outputs. BN as the
        module's mode says."""
        return self.heads(self.features(image))

    def decode_level(self, out: torch.Tensor, level: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Level ``level`` (0: stride 32) -> corner boxes (B, H W 3, 4) in
        input pixels (centre (s + cell) stride, size exp(t clipped into
        [-8, 8]) anchor), objectness logits (B, H W 3), class logits (B, H
        W 3, C)."""
        (wh,) = self.anchor_wh[level](out.device)
        return decode_anchor_level(out, wh, STRIDES[level], "exp")

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch: image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G) bool
        (``loss_from_outputs`` of the forward)."""
        return self.loss_from_outputs(self(batch["image"]), batch)

    def loss_from_outputs(self, outs: Sequence[torch.Tensor],
                          batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of the head outputs ``outs`` (stride 32, 16, 8) against
        the batch's ground truth. Returns (the levels' obj + 2 box + cls
        summed, {l{i}_obj, l{i}_box} per level, 0 the stride-32 one)."""
        gt_boxes, gt_classes, gt_mask = (batch["gt_boxes"],
                                         batch["gt_classes"],
                                         batch["gt_mask"])
        (all_wh,) = self.all_anchor_wh(gt_boxes.device)
        best = best_anchor(gt_boxes, all_wh)
        total = 0.0
        parts = {}
        for li, out in enumerate(outs):
            _, h, w, na, _ = out.shape
            boxes, obj, cls = self.decode_level(out, li)
            pos, tbox, tcls = yolov3_targets(gt_boxes, gt_classes, gt_mask,
                                             best, li, STRIDES[li], (h, w),
                                             na)
            total_pos = pos.sum()
            num_pos = torch.maximum(total_pos, torch.ones_like(total_pos))
            ign = ignore_mask(boxes, gt_boxes, gt_mask,
                              IGNORE_IOU).to(pos.dtype)
            obj_loss = (bce_with_logits(obj, pos)
                        * (pos + (1 - pos) * (1 - ign))).sum() / num_pos
            box_loss = ((1.0 - elementwise_iou(boxes, tbox)) * pos).sum() \
                / num_pos
            onehot = F.one_hot(tcls.long(), self.num_classes).to(pos.dtype)
            cls_loss = (bce_with_logits(cls, onehot).sum(-1)
                        * pos).sum() / num_pos
            total = total + obj_loss + BOX_WEIGHT * box_loss + cls_loss
            parts[f"l{li}_obj"] = obj_loss
            parts[f"l{li}_box"] = box_loss
        return total, parts

    def candidates(self, *outs: torch.Tensor, pre_nms: int = 1000
                   ) -> Dict[str, torch.Tensor]:
        """``best_class_candidates`` of every level's decoded boxes, each
        class scored sigmoid(class logit) x sigmoid(objectness), the levels
        concatenated in stride order 32, 16, 8."""
        boxes, scores = [], []
        for li, out in enumerate(outs):
            bx, obj, cls = self.decode_level(out, li)
            boxes.append(bx)
            scores.append(torch.sigmoid(cls) * torch.sigmoid(obj)[..., None])
        return best_class_candidates(torch.cat(boxes, 1),
                                     torch.cat(scores, 1), pre_nms)

    def detections(self, cand: Dict[str, torch.Tensor],
                   score_threshold: float = 0.05, nms_threshold: float = 0.45,
                   max_detections: int = 100) -> Dict:
        """``class_aware_detections`` at YOLOv3's thresholds."""
        return class_aware_detections(cand, score_threshold, nms_threshold,
                                      max_detections)

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, score_threshold: float = 0.05,
                nms_threshold: float = 0.45, max_detections: int = 100,
                pre_nms: int = 1000) -> Dict:
        """image (B, H, W, 3) -> ``detections`` of the ``pre_nms``
        ``candidates``: boxes (B, 100, 4) in input pixels, scores, labels,
        ``nms_passes``."""
        return self.detections(self.candidates(*self(image),
                                               pre_nms=pre_nms),
                               score_threshold, nms_threshold, max_detections)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YOLOv3":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN)."""
        init_flax_defaults_(self, generator)
        return self
