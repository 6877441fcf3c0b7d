"""YOLOv5 and the anchor-based YOLO core it shares with YOLOv4 and YOLOv7
(counterpart of ``minddet_tpu/models/detectors/yolov5.py``:
``YOLOV5_ANCHORS``, ``yolov5_assign``, ``_AnchorYOLO`` as ``AnchorYOLO``
with ``__call__`` as ``forward``, ``_decode_level`` (its body
``decode_anchor_level``, which YOLOv3 shares), ``loss`` and ``predict``,
and ``YOLOv5``).

The image is NHWC (B, H, W, 3) as in the reference and is cast to
``dtype``, the compute dtype, once; inside, activations are NCHW in
``channels_last`` memory. Each level's head output is (B, H, W, na, 5 + C)
f32 whatever ``dtype`` is (channel a (5 + C) + k of the 1x1 conv is anchor
a's entry k), and so are the decode, the assignment and the losses, as in
the reference. No hand-written kernel runs on these paths: convs, BN,
SiLU, max pools, nearest upsampling, sigmoids, an exp, an arctan and the
axis-aligned greedy NMS (``ops/nms.py:batched_nms``, one host sync per
pass).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import CSPDarknet
from minddet_tpu_torch.models.detectors.yolox import (best_class_candidates,
                                                      class_aware_detections)
from minddet_tpu_torch.models.layers import (Conv2d, DeviceArrays, clip,
                                             init_flax_defaults_, take_rows)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.models.necks.pan import PAN
from minddet_tpu_torch.ops.box import elementwise_ciou

# (w, h) pixel anchors per level, stride 8 / 16 / 32 (P3, P4, P5)
YOLOV5_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
# the loss weights of the reference: CIoU box, objectness, class
BOX_WEIGHT, OBJ_WEIGHT, CLS_WEIGHT = 0.05, 1.0, 0.5
# a GT claims an anchor whose width and height ratios to it stay under this
RATIO_THRESH = 4.0


def yolov5_assign(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  gt_mask: torch.Tensor, anchors_wh: torch.Tensor,
                  stride: float, hw: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """YOLOv5's assignment on one level, batched over B as the reference
    ``vmap``s its one-image function: ground truth (B, G, 4) xyxy pixels /
    (B, G) classes / (B, G) mask, this level's anchor shapes (na, 2) in
    pixels, its stride and (h, w) -> dense target maps flattened over
    (h, w, na): pos (B, h w na) {0, 1} in the boxes' dtype, tbox (B, h w
    na, 4) the matched GT box, tcls (B, h w na) int32 its class.

    A GT claims every anchor whose width and height ratios to it (each
    max(r, 1 / r)) stay under RATIO_THRESH, at its centre cell (the
    centre in cells clipped into [0, w - 1e-3] and truncated) and at the
    neighbour cells toward the nearer x and the nearer y edge (left and up
    where the centre's offset in its cell is under 0.5), where they lie on
    the map. Where several claims fall on one slot the last in (GT, cell,
    anchor) order wins, as the reference's ``.at[].set`` does on the CPU
    (a ``scatter_reduce`` of the writers' positions by max, so that the
    rule holds on the GPU too)."""
    h, w = hw
    b = gt_mask.shape[0]
    na = anchors_wh.shape[0]
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    rw = gw[..., None] / anchors_wh[:, 0].clamp(min=1e-8)
    rh = gh[..., None] / anchors_wh[:, 1].clamp(min=1e-8)
    ratio = torch.maximum(
        torch.maximum(rw, 1.0 / rw.clamp(min=1e-8)),
        torch.maximum(rh, 1.0 / rh.clamp(min=1e-8)))  # (B, G, na)
    anchor_ok = (ratio < RATIO_THRESH) & gt_mask[..., None]

    cx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5 / stride).clamp(
        0, w - 1e-3)
    cy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5 / stride).clamp(
        0, h - 1e-3)
    ix = cx.to(torch.int32)
    iy = cy.to(torch.int32)
    nx = torch.where(cx - ix.to(cx.dtype) < 0.5, ix - 1, ix + 1)
    ny = torch.where(cy - iy.to(cy.dtype) < 0.5, iy - 1, iy + 1)
    cand_x = torch.stack([ix, nx, ix], -1).long()  # (B, G, 3)
    cand_y = torch.stack([iy, iy, ny], -1).long()
    in_bounds = (cand_x >= 0) & (cand_x < w) & (cand_y >= 0) & (cand_y < h)

    slots = h * w * na
    base = cand_y * (w * na) + cand_x * na
    idx = base[..., None] + torch.arange(na, device=base.device)
    valid = in_bounds[..., None] & anchor_ok[:, :, None, :]  # (B, G, 3, na)
    idx = torch.where(valid, idx, torch.full_like(idx, slots)).reshape(b, -1)
    writer = torch.arange(idx.shape[1], device=idx.device).expand(b, -1)
    last = torch.full((b, slots + 1), -1, dtype=torch.long,
                      device=idx.device).scatter_reduce(1, idx, writer,
                                                        "amax")[:, :slots]
    pos = last >= 0
    gt_of = last.clamp(min=0) // (3 * na)
    tbox = torch.where(pos[..., None], take_rows(gt_boxes, gt_of),
                       torch.zeros((), dtype=gt_boxes.dtype,
                                   device=gt_boxes.device))
    tcls = torch.where(pos, torch.gather(gt_classes, 1, gt_of),
                       torch.zeros_like(gt_of, dtype=gt_classes.dtype))
    return pos.to(gt_boxes.dtype), tbox, tcls.to(torch.int32)


def decode_anchor_level(out: torch.Tensor, anchors_wh: torch.Tensor,
                        stride: int, flavor: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level's head output (B, H, W, na, 5 + C) with its anchor shapes
    (na, 2) in pixels -> corner boxes (B, H W na, 4) in input pixels,
    objectness logits (B, H W na), class logits (B, H W na, C), flattened
    over (H, W, na). ``flavor`` "sigmoid2": centre (2 s - 0.5 + cell)
    stride, size (2 s)² anchor; "exp" (YOLOv3's and v4's): centre (s +
    cell) stride, size exp(t clipped into [-8, 8]) anchor."""
    b, h, w, na, _ = out.shape
    gy = torch.arange(h, dtype=torch.float32,
                      device=out.device)[None, :, None, None]
    gx = torch.arange(w, dtype=torch.float32,
                      device=out.device)[None, None, :, None]
    aw, ah = anchors_wh[:, 0], anchors_wh[:, 1]
    if flavor == "sigmoid2":
        s = torch.sigmoid(out[..., :4])
        cx = (2.0 * s[..., 0] - 0.5 + gx) * stride
        cy = (2.0 * s[..., 1] - 0.5 + gy) * stride
        bw = (2.0 * s[..., 2]) ** 2 * aw
        bh = (2.0 * s[..., 3]) ** 2 * ah
    else:
        cx = (torch.sigmoid(out[..., 0]) + gx) * stride
        cy = (torch.sigmoid(out[..., 1]) + gy) * stride
        bw = torch.exp(clip(out[..., 2], -8.0, 8.0)) * aw
        bh = torch.exp(clip(out[..., 3], -8.0, 8.0)) * ah
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    return (boxes.reshape(b, -1, 4), out[..., 4].reshape(b, -1),
            out[..., 5:].reshape(b, -1, out.shape[-1] - 5))


class AnchorYOLO(nn.Module):
    """The anchor-based YOLO core (v4, v5, v7): ``backbone``, ``PAN`` at
    (256, 512, 1024) scaled by ``width_mult`` (depth 1), a 1x1 ``head{i}``
    of na (5 + C) channels per level, the ratio / cross-grid assignment
    (``yolov5_assign``), the CIoU box loss and the IoU-weighted objectness.
    ``decode_flavor`` "sigmoid2" (v5, v7: centre (2 s - 0.5 + cell) stride,
    size (2 s)² anchor) or "exp" (v3, v4: centre (s + cell) stride, size
    exp(t clipped into [-8, 8]) anchor). A subclass picks its backbone in
    ``make_backbone``."""

    # the objectness BCE's weight per level (P3, P4, P5)
    OBJ_BALANCE = (4.0, 1.0, 0.4)
    STRIDES = (8, 16, 32)

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (640, 640),
                 anchors=YOLOV5_ANCHORS, decode_flavor: str = "sigmoid2",
                 width_mult: float = 0.5, depth_mult: float = 0.33,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if decode_flavor not in ("sigmoid2", "exp"):
            raise ValueError(f"decode_flavor must be 'sigmoid2' or 'exp', "
                             f"got {decode_flavor!r}")
        self.num_classes = num_classes
        self.image_hw = tuple(image_hw)
        self.anchors = tuple(tuple(tuple(a) for a in lv) for lv in anchors)
        self.decode_flavor = decode_flavor
        self.width_mult = width_mult
        self.depth_mult = depth_mult
        self.dtype = dtype
        self.backbone = self.make_backbone()
        neck = self.neck_channels()
        self.neck = PAN(self.backbone.out_channels, neck)
        for i, (c, lv) in enumerate(zip(neck, self.anchors)):
            self.add_module(f"head{i}", Conv2d(c, len(lv) * (5 + num_classes),
                                               1))
        # anchor_wh[l](device): level l's anchor widths and heights (na, 2),
        # f32
        self.anchor_wh = [DeviceArrays(np.asarray(lv, np.float32))
                          for lv in self.anchors]

    def make_backbone(self) -> nn.Module:
        """YOLOv5's ``CSPDarknet(depths=(3, 6, 9, 3))`` without C2f."""
        return CSPDarknet(self.depth_mult, self.width_mult,
                          depths=(3, 6, 9, 3))

    def neck_channels(self) -> Tuple[int, int, int]:
        def w(c):
            return max(16, int(c * self.width_mult // 8 * 8))

        return w(256), w(512), w(1024)

    def features(self, image: torch.Tensor):
        """image (B, H, W, 3) -> ((C3, C4, C5), (N3, N4, N5)), NCHW maps in
        ``dtype``."""
        feats = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        return feats, self.neck(feats)

    def heads(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """(N3, N4, N5) -> each level's (B, H, W, na, 5 + C), f32."""
        outs = []
        for i, f in enumerate(feats):
            o = getattr(self, f"head{i}")(f).permute(0, 2, 3, 1)
            b, h, w, _ = o.shape
            outs.append(o.reshape(b, h, w, len(self.anchors[i]),
                                  5 + self.num_classes).float())
        return outs

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image (B, H, W, 3) -> the head outputs of strides 8, 16 and 32,
        each (B, H, W, na, 5 + C) f32. BN as the module's mode says."""
        return self.heads(self.features(image)[1])

    def decode_level(self, out: torch.Tensor, level: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One level's head output (B, H, W, na, 5 + C) -> corner boxes (B,
        H W na, 4) in input pixels, objectness logits (B, H W na), class
        logits (B, H W na, C), flattened over (H, W, na)."""
        (wh,) = self.anchor_wh[level](out.device)
        return decode_anchor_level(out, wh, self.STRIDES[level],
                                   self.decode_flavor)

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch: image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G) bool.
        Per level, with ``yolov5_assign``'s positives: 1 - CIoU over the
        positives' count (at least 1); the objectness BCE against pos x
        CIoU (detached, clipped into [0, 1]) as a mean over every (B, H, W,
        na) entry, times ``OBJ_BALANCE``; the class BCE summed over the
        classes, over the positives' count. Returns (0.05 box + obj + 0.5
        cls summed over the levels, {box_loss, obj_loss, cls_loss})."""
        outs = self(batch["image"])
        gt_boxes, gt_classes, gt_mask = (batch["gt_boxes"],
                                         batch["gt_classes"],
                                         batch["gt_mask"])
        box_l = obj_l = cls_l = 0.0
        for li, out in enumerate(outs):
            _, h, w, _, _ = out.shape
            boxes, obj, cls = self.decode_level(out, li)
            (anchors_wh,) = self.anchor_wh[li](out.device)
            pos, tbox, tcls = yolov5_assign(
                gt_boxes, gt_classes, gt_mask, anchors_wh, self.STRIDES[li],
                (h, w))
            total_pos = pos.sum()
            num_pos = torch.maximum(total_pos, torch.ones_like(total_pos))
            ciou = elementwise_ciou(boxes, tbox)
            box_l = box_l + ((1.0 - ciou) * pos).sum() / num_pos
            tobj = pos * clip(ciou, 0.0, 1.0).detach()
            obj_l = obj_l + (bce_with_logits(obj, tobj).mean()
                             * self.OBJ_BALANCE[li])
            onehot = F.one_hot(tcls.long(), self.num_classes).to(cls.dtype)
            cls_l = cls_l + (bce_with_logits(cls, onehot).sum(-1)
                             * pos).sum() / num_pos
        total = BOX_WEIGHT * box_l + OBJ_WEIGHT * obj_l + CLS_WEIGHT * cls_l
        return total, {"box_loss": box_l, "obj_loss": obj_l,
                       "cls_loss": cls_l}

    def candidates(self, *outs: torch.Tensor, pre_nms: int = 1000
                   ) -> Dict[str, torch.Tensor]:
        """``best_class_candidates`` of every level's decoded boxes, each
        class scored sigmoid(class logit) x sigmoid(objectness), the levels
        concatenated."""
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
        """``class_aware_detections`` at the anchor YOLOs' thresholds."""
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
    def init_weights(self, generator: torch.Generator) -> "AnchorYOLO":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN)."""
        init_flax_defaults_(self, generator)
        return self


class YOLOv5(AnchorYOLO):
    """YOLOv5: ``CSPDarknet(3, 6, 9, 3)``, ``PAN`` and the sigmoid² anchor
    head; YOLOv5-s by default (width 0.5, depth 0.33)."""
