"""Faster R-CNN and Mask R-CNN, ResNet-FPN (counterpart of
``minddet_tpu/models/detectors/faster_rcnn.py``: ``__call__`` as
``forward``, ``predict`` and ``loss``).

The image is NHWC (B, H, W, 3) as in the reference and is cast to
``dtype``, the compute dtype, once; inside, activations are NCHW in
``channels_last`` memory. ROIAlign reads each pyramid level's NHWC view in
place (``ops/roi_align.py``): on the GPU one row-gather kernel launch per
level and roi set, four for the boxes and four more for the masks; in
``loss`` the backward to the pyramid adds one launch of the row gather's
map gradient per level and roi set, and Mask R-CNN's mask targets one more
row-gather launch (the GT bitmaps' crop).

Where the reference draws from its ``sampling`` key inside ``loss`` (one
key per image for the RPN targets, one for the ROI sampler), the port takes
the uniform draws as tensors (``sampling_draws`` makes them from a
``torch.Generator``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.heads.roi_head import (BoxHead, MaskHead,
                                                     box_head_loss,
                                                     box_head_predict,
                                                     mask_head_loss,
                                                     sample_proposals)
from minddet_tpu_torch.models.heads.rpn_head import (RPNHead,
                                                     generate_proposals)
from minddet_tpu_torch.models.layers import (DeviceArrays,
                                             init_flax_defaults_,
                                             variance_scaling_)
from minddet_tpu_torch.models.losses import bce_with_logits
from minddet_tpu_torch.models.necks.fpn import FPN
from minddet_tpu_torch.ops.anchors2d import (level_shape, multilevel_anchors,
                                             rpn_targets)
from minddet_tpu_torch.ops.roi_align import multilevel_roi_align

FPN_CHANNELS = 256
BOX_ROI = (7, 7)
MASK_ROI = (14, 14)


class FasterRCNN(nn.Module):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 image_hw: Tuple[int, int] = (512, 512),
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_scales: Sequence[float] = (8.0,),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 rpn_pre_nms: int = 1000, rpn_post_nms: int = 512,
                 roi_samples: int = 256, with_mask: bool = False,
                 mask_stride: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.image_hw = tuple(image_hw)
        self.strides = tuple(strides)
        self.rpn_pre_nms = rpn_pre_nms
        self.rpn_post_nms = rpn_post_nms
        self.roi_samples = roi_samples
        self.with_mask = with_mask
        self.mask_stride = mask_stride
        self.dtype = dtype
        na = len(anchor_scales) * len(anchor_ratios)
        self.backbone = ResNet(depth=depth)
        self.fpn = FPN(self.backbone.out_channels, FPN_CHANNELS,
                       extra_levels=len(strides) - 4)
        self.rpn = RPNHead(FPN_CHANNELS, na)
        self.box_head = BoxHead(FPN_CHANNELS * BOX_ROI[0] * BOX_ROI[1],
                                num_classes)
        if with_mask:
            self.mask_head = MaskHead(FPN_CHANNELS, num_classes)
        self.level_sizes = [
            level_shape(self.image_hw, s)[0] * level_shape(
                self.image_hw, s)[1] * na for s in self.strides]
        self._anchors = DeviceArrays(multilevel_anchors(
            self.image_hw, self.strides, anchor_scales, anchor_ratios))

    @property
    def anchors(self) -> torch.Tensor:
        """Every level's anchors (A, 4), f32 under any compute dtype (as the
        reference keeps them), on the parameters' device."""
        return self._anchors(next(self.parameters()).device)[0]

    def forward(self, image: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """image (B, H, W, 3) -> (pyramid levels P2.. as NCHW
        ``channels_last`` maps in ``dtype``, RPN objectness (B, A) f32, RPN
        deltas (B, A, 4) f32)."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        pyramids = self.fpn(self.backbone(x))
        logits, deltas = self.rpn(pyramids)
        return pyramids, logits, deltas

    def roi_features(self, pyramids: Sequence[torch.Tensor],
                     boxes: torch.Tensor, output_size: Tuple[int, int]
                     ) -> torch.Tensor:
        """FPN ROIAlign of (B, R, 4) image-coordinate boxes over P2-P5 ->
        (B, R, ph, pw, C) f32."""
        maps = [p.permute(0, 2, 3, 1) for p in pyramids[:4]]
        return multilevel_roi_align(maps, boxes, self.strides[:4],
                                    output_size)

    def proposals(self, logits: torch.Tensor, deltas: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        return generate_proposals(logits, deltas, self.anchors,
                                  self.level_sizes, self.image_hw,
                                  self.rpn_pre_nms, self.rpn_post_nms)

    def num_proposals(self) -> int:
        """K, the proposals per image: ``rpn_post_nms``, or fewer where the
        levels hold fewer NMS candidates."""
        cand = sum(min(self.rpn_pre_nms, n) for n in self.level_sizes)
        return min(self.rpn_post_nms, cand)

    def sampling_draws(self, batch: int, gt_slots: int,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The uniform draws of one ``loss`` call, from ``generator`` on its
        device: ``rpn`` (B, 2, A) for the RPN targets' sampler (the
        reference's ``r1`` and ``r2`` of each image), ``roi`` (B, 3, K + G)
        for the ROI sampler (its ``r1``, ``r2`` and the unsplit key's draw
        that ranks the chosen candidates)."""
        dev = generator.device
        a = self.anchors.shape[0]
        n = self.num_proposals() + gt_slots
        return {"rpn": torch.rand(batch, 2, a, generator=generator,
                                  device=dev),
                "roi": torch.rand(batch, 3, n, generator=generator,
                                  device=dev)}

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch: image (B, H, W, 3), gt_boxes (B, G,
        4) in input pixels, gt_classes (B, G) 0-based, gt_mask (B, G) bool;
        with the mask branch also gt_bitmaps (B, H / s, W / s, G) f32 at
        ``mask_stride`` s. ``draws`` as ``sampling_draws`` makes them.
        Returns (total, parts): rpn_cls (the objectness BCE over the
        sampled anchors), rpn_reg (smooth L1, beta 1/9, over the sampled
        positives), roi_cls, roi_reg (``box_head_loss``) and with the mask
        branch mask (``mask_head_loss``).

        The proposals come from the detached RPN outputs (``proposals``),
        so no gradient reaches the RPN through them, nor the sample points
        of any ROIAlign; the backward of each ROIAlign reaches the pyramid
        only."""
        image, gt_boxes, gt_mask = (batch["image"], batch["gt_boxes"],
                                    batch["gt_mask"])
        pyramids, logits, deltas = self(image)

        t = rpn_targets(draws["rpn"][:, 0], draws["rpn"][:, 1], self.anchors,
                        gt_boxes, gt_mask)
        lbl = (t["labels"] == 1).to(logits.dtype)
        bce = bce_with_logits(logits, lbl)
        w = t["cls_weights"]
        rpn_cls = (bce * w).sum() / w.sum().clamp(min=1.0)
        diff = (deltas - t["deltas"]).abs()
        sl1 = torch.where(diff < 1.0 / 9.0, 4.5 * diff * diff,
                          diff - 1.0 / 18.0)
        rw = t["reg_weights"]
        rpn_reg = (sl1.sum(-1) * rw).sum() / rw.sum().clamp(min=1.0)

        proposals, _, _ = self.proposals(logits.detach(), deltas.detach())
        roi = draws["roi"]
        samp = sample_proposals(roi[:, 0], roi[:, 1], roi[:, 2], proposals,
                                gt_boxes, batch["gt_classes"], gt_mask,
                                self.roi_samples)
        feats = self.roi_features(pyramids, samp["rois"], BOX_ROI)
        cls_logits, box_deltas = self.box_head(feats.to(self.dtype))
        roi_cls, roi_reg = box_head_loss(cls_logits, box_deltas, samp)
        parts = {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "roi_cls": roi_cls,
                 "roi_reg": roi_reg}
        total = rpn_cls + rpn_reg + roi_cls + roi_reg
        if self.with_mask:
            feats = self.roi_features(pyramids, samp["rois"], MASK_ROI)
            mask_logits = self.mask_head(feats.to(self.dtype))
            parts["mask"] = mask_head_loss(mask_logits, batch["gt_bitmaps"],
                                           samp, stride=self.mask_stride)
            total = total + parts["mask"]
        return total, parts

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, score_threshold: float = 0.05,
                nms_threshold: float = 0.5, max_detections: int = 100
                ) -> Dict[str, torch.Tensor]:
        """image (B, H, W, 3) -> boxes (B, D, 4) in input pixels, scores (B,
        D), labels (B, D) (-1 in empty slots), with the mask branch masks
        (B, D, 28, 28) (sigmoid of the label's mask, in roi coordinates),
        and ``nms_passes`` (the RPN NMS's, the box NMS's)."""
        pyramids, logits, deltas = self(image)
        proposals, _, rpn_passes = self.proposals(logits, deltas)
        roi_feats = self.roi_features(pyramids, proposals, BOX_ROI)
        cls_logits, box_deltas = self.box_head(roi_feats.to(self.dtype))
        out = box_head_predict(cls_logits, box_deltas, proposals,
                               self.image_hw, score_threshold,
                               nms_threshold, max_detections)
        out["nms_passes"] = (rpn_passes, out["nms_passes"])
        if self.with_mask:
            out["masks"] = torch.sigmoid(
                self.mask_logits(pyramids, out["boxes"], out["labels"]))
        return out

    def mask_logits(self, pyramids: Sequence[torch.Tensor],
                    boxes: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
        """The mask branch at (B, D, 4) detections: each one's mask logits
        of its label (class 0 for an empty slot) -> (B, D, 28, 28)."""
        feats = self.roi_features(pyramids, boxes, MASK_ROI)
        logits = self.mask_head(feats.to(self.dtype))
        idx = labels.clamp(min=0)[:, :, None, None, None]
        return torch.gather(logits, -1,
                            idx.expand(*logits.shape[:-1], 1))[..., 0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FasterRCNN":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN), but
        He-normal for the ResNet stem and every ``BasicBlock`` conv, as the
        reference's ResNet sets them (its ``Bottleneck`` convs keep flax's
        default)."""
        init_flax_defaults_(self, generator)
        for m in self.backbone.he_convs():
            variance_scaling_(m.weight, 2.0, m.weight[0].numel(), generator)
        return self


class MaskRCNN(FasterRCNN):
    """Faster R-CNN with the mask branch."""

    def __init__(self, **kwargs):
        super().__init__(with_mask=True, **kwargs)
