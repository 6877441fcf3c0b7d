"""CenterNet detector: ResNet(-DCN) -> deconv neck -> hm/wh/reg heads
(counterpart of ``minddet_tpu/models/detectors/centernet.py``).

``forward`` returns the raw NHWC heads, ``loss`` and ``loss_from_gt`` the
training objective, and ``predict`` runs forward + decode (the serving
program). BN follows the module's mode (``train()`` / ``eval()``), where
flax takes ``train=``. ``dtype`` is the reference's compute dtype: the image
is cast to it and every layer computes in it, whatever the parameters'
dtype (f32 master weights train a bf16 network, as in flax). Inside,
activations are NCHW in ``channels_last`` memory: the NHWC image's
``permute(0, 3, 1, 2)`` already is one, and every conv, BN, pool and add on
the path keeps it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.heads.centernet_head import (CenterNetHead,
                                                           _Branch)
from minddet_tpu_torch.models.layers import (ModulatedDeformConv,
                                             variance_scaling_)
from minddet_tpu_torch.models.losses import (centernet_focal_loss,
                                             gather_reg_loss)
from minddet_tpu_torch.models.necks.ct_deconv import (NUM_FILTERS,
                                                      CenterNetDeconvNeck)
from minddet_tpu_torch.ops.decode import centernet_decode
from minddet_tpu_torch.ops.targets import centernet_targets_batch

Targets = Dict[str, torch.Tensor]


class CenterNet(nn.Module):
    def __init__(self, num_classes: int = 80, depth: int = 18,
                 dcn: bool = True, hm_weight: float = 1.0,
                 wh_weight: float = 0.1, off_weight: float = 1.0,
                 reg_loss: str = "l1", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNet(depth=depth,
                               dcn_stages=(False, dcn, dcn, dcn))
        self.neck = CenterNetDeconvNeck(self.backbone.out_channels[-1])
        self.head = CenterNetHead(NUM_FILTERS[-1], num_classes)
        self.num_classes = num_classes
        self.hm_weight = hm_weight
        self.wh_weight = wh_weight
        self.off_weight = off_weight
        self.reg_loss = reg_loss
        self.dtype = dtype

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (B, H, W, 3) -> dict of NHWC heads at stride 4."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        return self.head(self.neck(self.backbone(x)))

    def loss(self, image: torch.Tensor, targets: Targets
             ) -> Tuple[torch.Tensor, Targets]:
        """Training objective against targets hm (B,H,W,C), wh (B,O,2), reg
        (B,O,2), ind (B,O), reg_mask (B,O), the columns of
        ``ops.targets.centernet_targets_batch``. Returns (total, {hm_loss,
        wh_loss, off_loss}); BN as the module's mode says (train for the
        reference's ``train=True``)."""
        outputs = self(image)
        hm_loss = centernet_focal_loss(outputs["hm"], targets["hm"])
        wh_loss = gather_reg_loss(outputs["wh"], targets["reg_mask"],
                                  targets["ind"], targets["wh"],
                                  mode=self.reg_loss)
        off_loss = torch.zeros((), device=image.device)
        if self.off_weight > 0:
            off_loss = gather_reg_loss(outputs["reg"], targets["reg_mask"],
                                       targets["ind"], targets["reg"],
                                       mode=self.reg_loss)
        total = (self.hm_weight * hm_loss + self.wh_weight * wh_loss
                 + self.off_weight * off_loss)
        return total, {"hm_loss": hm_loss, "wh_loss": wh_loss,
                       "off_loss": off_loss}

    def loss_from_gt(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Targets]:
        """batch {image, gt_boxes (B,O,4) in input pixels, gt_classes,
        gt_mask} -> targets built on the device at stride 4 (min overlap
        0.7) -> ``loss``."""
        b, h, w = batch["image"].shape[:3]
        targets = centernet_targets_batch(
            batch["gt_boxes"] / 4.0, batch["gt_classes"], batch["gt_mask"],
            h // 4, w // 4, self.num_classes, 0.7)
        return self.loss(batch["image"], targets)

    @torch.inference_mode()
    def predict(self, image: torch.Tensor, k: int = 100) -> torch.Tensor:
        """Forward + decode -> (B, K, 6) [x1, y1, x2, y2, score, class] at
        output stride 4."""
        return centernet_decode(self(image), k=k)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CenterNet":
        """The reference's initialisers, drawn from ``generator``: He-normal
        for the backbone and DCN kernels, LeCun-normal for the head convs
        and transposed convs (flax's default), zero offset/mask convs, zero
        biases but the heatmap's -2.19, identity BN (scale 1, bias 0, mean
        0, var 1)."""
        offset = {id(m.conv_offset) for m in self.modules()
                  if isinstance(m, ModulatedDeformConv)}
        he = {id(m) for m in self.backbone.modules()
              if isinstance(m, nn.Conv2d)}
        for m in self.modules():
            if isinstance(m, ModulatedDeformConv):
                kh, kw, cin, _ = m.kernel.shape
                variance_scaling_(m.kernel, 2.0, kh * kw * cin, generator)
            elif id(m) in offset:
                nn.init.zeros_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # Conv2d weight (O, I, kh, kw), ConvTranspose2d (I, O, kh,
                # kw): fan_in = I*kh*kw either way
                i = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d)
                                   else 1]
                fan_in = i * m.weight.shape[2] * m.weight.shape[3]
                variance_scaling_(m.weight, 2.0 if id(m) in he else 1.0,
                                  fan_in, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
        for m in self.modules():
            if isinstance(m, _Branch):
                nn.init.constant_(m.out.bias, m.final_bias)
        return self
