"""SSD-300 with MobileNetV2: multibox anchors, the loss with static 3:1
hard-negative mining, decode and NMS (counterpart of
``minddet_tpu/models/detectors/ssd.py``: ``SSD_REG_STDS``, ``ssd_anchors``,
``_MultiboxLayer`` as ``MultiboxLayer``, ``ExtraBlock`` and ``SSD`` with
``__call__`` as ``forward``, ``loss`` and ``predict``; the loss's
one-image ``per_image`` is ``ssd_targets`` here, batched, and its mining
``hard_negatives``).

The image is NHWC (B, H, W, 3) and is cast to ``dtype``, the compute
dtype, once; inside, activations are NCHW in ``channels_last`` memory. The
heads' outputs are f32 whatever ``dtype`` is, and so are the targets, the
losses and the decode. The anchors are f32 pixels kept outside the
module's buffers (``DeviceArrays``), so a cast of the model to bf16 leaves
them as they are. No hand-written kernel runs on these paths: convs
(depthwise in MobileNetV2), BN, ReLU6, softmax, sorts and the axis-aligned
greedy NMS.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.mobilenet import MobileNetV2, bn
from minddet_tpu_torch.models.detectors.yolox import (best_class_candidates,
                                                      class_aware_detections)
from minddet_tpu_torch.models.layers import (Conv2d, DeviceArrays,
                                             init_flax_defaults_, take_rows)
from minddet_tpu_torch.ops.anchors2d import match_anchors
from minddet_tpu_torch.ops.box import clip_boxes, decode_deltas, encode_deltas

SSD_REG_STDS = (0.1, 0.1, 0.2, 0.2)
MATCH_IOU = 0.5  # positive from this IoU on, negative below it
NEG_POS_RATIO = 3.0  # negatives kept per positive by the mining
MIN_SCALE, MAX_SCALE = 0.2, 0.95  # the anchors' sides on the first and last
# map, as a share of the image
ANCHOR_RATIOS = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)  # w / h of each map's boxes
EXTRA_CHANNELS = (512, 256, 256, 128)  # the extra blocks' widths
ANCHORS_PER_LOC = len(ANCHOR_RATIOS) + 1  # the ratios' boxes, one between
# two scales


def ssd_anchors(image_size: int = 300,
                feature_sizes: Sequence[int] = (19, 10, 5, 3, 2, 1)
                ) -> Tuple[np.ndarray, List[int]]:
    """Classic SSD multibox anchors -> ((A, 4) f32 xyxy pixels, per-level
    counts). Level k of m: scale s_k from ``MIN_SCALE`` to ``MAX_SCALE``
    linearly (s_m = 1), a box of s_k sqrt(r) x s_k / sqrt(r) per ratio r
    of ``ANCHOR_RATIOS`` and one of sqrt(s_k s_{k + 1}) square, centred on
    every cell ((x + 0.5) / f, (y + 0.5) / f), cell-major."""
    m = len(feature_sizes)
    scales = [MIN_SCALE + (MAX_SCALE - MIN_SCALE) * k / (m - 1)
              for k in range(m)]
    scales.append(1.0)
    all_anchors, counts = [], []
    for k, f in enumerate(feature_sizes):
        s = scales[k]
        boxes = [(s * np.sqrt(r), s / np.sqrt(r)) for r in ANCHOR_RATIOS]
        boxes.append((np.sqrt(scales[k] * scales[k + 1]),) * 2)
        boxes = np.asarray(boxes, np.float32)
        ys, xs = np.meshgrid((np.arange(f) + 0.5) / f,
                             (np.arange(f) + 0.5) / f, indexing="ij")
        cxy = np.stack([xs, ys], -1).reshape(-1, 1, 2)
        wh = boxes[None]
        a = np.concatenate([cxy - wh / 2, cxy + wh / 2],
                           axis=-1).reshape(-1, 4) * image_size
        all_anchors.append(a.astype(np.float32))
        counts.append(len(a))
    return np.concatenate(all_anchors, 0), counts


class MultiboxLayer(nn.Module):
    """One map's 3x3 ``cls`` (``num_anchors`` (C + 1) logits, background
    first) and ``reg`` (``num_anchors`` 4 deltas) convs with biases ->
    ((B, H W na, C + 1), (B, H W na, 4)) f32, cell-major."""

    def __init__(self, in_channels: int, num_anchors: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.cls = Conv2d(in_channels, num_anchors * (num_classes + 1), 3,
                          padding=1)
        self.reg = Conv2d(in_channels, num_anchors * 4, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        cls = self.cls(x).permute(0, 2, 3, 1).reshape(
            b, -1, self.num_classes + 1)
        reg = self.reg(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return cls.float(), reg.float()


class ExtraBlock(nn.Module):
    """1x1 ``c1`` to half of ``features``, ``bn1``, ReLU6, 3x3 stride-2
    ``c2`` to ``features``, ``bn2``, ReLU6 (flax's BN momentum 0.9, eps
    1e-5)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.c1 = Conv2d(in_channels, features // 2, 1, bias=False)
        self.bn1 = bn(features // 2)
        self.c2 = Conv2d(features // 2, features, 3, stride=2, padding=1,
                         bias=False)
        self.bn2 = bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.bn1(self.c1(x)))
        return F.relu6(self.bn2(self.c2(x)))


def ssd_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``per_image``, batched: anchors (A, 4), ground truth
    (B, G, 4) / (B, G) / (B, G) -> labels (B, A) int64 (``match_anchors``
    at 0.5 / 0.5, each GT's best anchors forced positive, ties included: 1
    positive, 0 negative), the class target (B, A) int64 (the matched GT's
    class + 1 where positive, 0 the background elsewhere), the box target
    (B, A, 4): the matched GT's deltas with ``SSD_REG_STDS``."""
    labels, match = match_anchors(anchors, gt_boxes, gt_mask, MATCH_IOU,
                                  MATCH_IOU)
    cls_t = torch.where(labels == 1,
                        torch.gather(gt_classes, 1, match).long() + 1,
                        torch.zeros_like(match))
    reg_t = encode_deltas(take_rows(gt_boxes, match), anchors,
                          stds=SSD_REG_STDS)
    return labels, cls_t, reg_t


def hard_negatives(ce: torch.Tensor, labels: torch.Tensor,
                   n_pos: torch.Tensor) -> torch.Tensor:
    """The static mining: per image, the negatives (``labels`` 0) ranked by
    their cross entropy ``ce`` (B, A), the largest first and the lower
    anchor first among equal ones (the reference's stable
    ``argsort(argsort(-ce))``, positives at the end), and those ranked
    under ``NEG_POS_RATIO`` x the image's positives ``n_pos`` (B, 1) kept:
    (B, A) bool."""
    neg_ce = torch.where(labels == 0, ce, torch.full_like(ce, -float("inf")))
    order = torch.sort(-neg_ce, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order))
    return (rank.to(n_pos.dtype) < NEG_POS_RATIO * n_pos) & (labels == 0)


class SSD(nn.Module):
    """``MobileNetV2``'s (C4, C5), ``extra{i}`` ``ExtraBlock``s at
    ``EXTRA_CHANNELS`` each halving the last map, and a ``multibox{i}``
    ``MultiboxLayer`` of ``ANCHORS_PER_LOC`` anchors on each of the six
    maps; anchors ``ssd_anchors`` at ``feature_sizes``."""

    def __init__(self, num_classes: int = 80, image_size: int = 300,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        self.dtype = dtype
        self.backbone = MobileNetV2()
        chans = list(self.backbone.out_channels)
        for i, c in enumerate(EXTRA_CHANNELS):
            self.add_module(f"extra{i}", ExtraBlock(chans[-1], c))
            chans.append(c)
        for i, c in enumerate(chans):
            self.add_module(f"multibox{i}", MultiboxLayer(
                c, ANCHORS_PER_LOC, num_classes))
        # anchor_boxes(device): (A, 4) f32 pixels
        self.anchor_boxes = DeviceArrays(self.anchors()[0])

    def feature_sizes(self) -> List[int]:
        """The six maps' sides: ceil(s / 16), ceil(s / 32), then halved
        (rounding up) per extra block."""
        s = self.image_size
        sizes = [-(-s // 16), -(-s // 32)]
        for _ in EXTRA_CHANNELS:
            sizes.append(-(-sizes[-1] // 2))
        return sizes

    def anchors(self) -> Tuple[np.ndarray, List[int]]:
        return ssd_anchors(self.image_size, tuple(self.feature_sizes()))

    def features(self, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """image (B, H, W, 3) -> the six NCHW maps in ``dtype``."""
        feats = list(self.backbone(image.to(self.dtype).permute(0, 3, 1, 2)))
        for i in range(len(EXTRA_CHANNELS)):
            feats.append(getattr(self, f"extra{i}")(feats[-1]))
        return tuple(feats)

    def heads(self, feats: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The six maps -> class logits (B, A, C + 1) and box deltas (B, A,
        4), f32, the maps one after another."""
        outs = [getattr(self, f"multibox{i}")(f) for i, f in enumerate(feats)]
        return (torch.cat([o[0] for o in outs], 1),
                torch.cat([o[1] for o in outs], 1))

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) -> ``heads``' (class logits, box deltas). BN
        as the module's mode says."""
        return self.heads(self.features(image))

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The multibox loss of a batch (image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G)):
        ``loss_from_outputs`` of the forward."""
        return self.loss_from_outputs(*self(batch["image"]), batch)

    def loss_from_outputs(self, cls_logits: torch.Tensor,
                          reg_preds: torch.Tensor,
                          batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The softmax cross entropy of the positives and of the
        ``hard_negatives``, and the smooth L1 (knee 1) of the positives'
        deltas, each over the batch's positives (at least 1). Returns
        (cls_loss + reg_loss, {cls_loss, reg_loss})."""
        (anchors,) = self.anchor_boxes(cls_logits.device)
        labels, cls_t, reg_t = ssd_targets(anchors, batch["gt_boxes"],
                                           batch["gt_classes"],
                                           batch["gt_mask"])
        pos = (labels == 1).float()
        n_pos = pos.sum(dim=1, keepdim=True)
        logp = F.log_softmax(cls_logits, dim=-1)
        ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
        neg_keep = hard_negatives(ce, labels, n_pos)
        total_pos = n_pos.sum()
        denom = torch.maximum(total_pos, torch.ones_like(total_pos))
        cls_loss = (ce * (pos + neg_keep.float())).sum() / denom
        diff = (reg_preds - reg_t).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        reg_loss = (sl1.sum(-1) * pos).sum() / denom
        return cls_loss + reg_loss, {"cls_loss": cls_loss,
                                     "reg_loss": reg_loss}

    def candidates(self, cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                   pre_nms: int = 400) -> Dict[str, torch.Tensor]:
        """The foreground classes' softmax scores (background dropped) and
        the decoded boxes (``SSD_REG_STDS``, clipped to the image) ->
        ``best_class_candidates``, the ``pre_nms`` best anchors."""
        (anchors,) = self.anchor_boxes(cls_logits.device)
        probs = torch.softmax(cls_logits, dim=-1)[..., 1:]
        boxes = clip_boxes(decode_deltas(reg_preds, anchors,
                                         stds=SSD_REG_STDS),
                           self.image_size, self.image_size)
        return best_class_candidates(boxes, probs, pre_nms)

    def detections(self, cand: Dict[str, torch.Tensor],
                   score_threshold: float = 0.05, nms_threshold: float = 0.45,
                   max_detections: int = 100) -> Dict:
        """``class_aware_detections`` at SSD's thresholds."""
        return class_aware_detections(cand, score_threshold, nms_threshold,
                                      max_detections)

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, score_threshold: float = 0.05,
                nms_threshold: float = 0.45, max_detections: int = 100,
                pre_nms: int = 400) -> Dict:
        """image (B, H, W, 3) -> ``detections`` of the ``pre_nms``
        ``candidates``: boxes (B, 100, 4) in input pixels, scores, labels,
        ``nms_passes``."""
        return self.detections(self.candidates(*self(image), pre_nms=pre_nms),
                               score_threshold, nms_threshold, max_detections)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SSD":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN)."""
        init_flax_defaults_(self, generator)
        return self
