"""CenterNet detector: ResNet(-DCN) -> deconv neck -> hm/wh/reg heads
(counterpart of ``minddet_tpu/models/detectors/centernet.py``).

``forward`` returns the raw NHWC heads and ``predict`` runs forward + decode
(the serving program). The training objective comes with the training step.
Inside, activations are NCHW in ``channels_last`` memory: the NHWC image's
``permute(0, 3, 1, 2)`` already is one, and every conv, BN, pool and add on
the path keeps it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.heads.centernet_head import (CenterNetHead,
                                                           _Branch)
from minddet_tpu_torch.models.layers import ModulatedDeformConv
from minddet_tpu_torch.models.necks.ct_deconv import (NUM_FILTERS,
                                                      CenterNetDeconvNeck)
from minddet_tpu_torch.ops.decode import centernet_decode


class CenterNet(nn.Module):
    def __init__(self, num_classes: int = 80, depth: int = 18,
                 dcn: bool = True):
        super().__init__()
        self.backbone = ResNet(depth=depth,
                               dcn_stages=(False, dcn, dcn, dcn))
        self.neck = CenterNetDeconvNeck(self.backbone.out_channels[-1])
        self.head = CenterNetHead(NUM_FILTERS[-1], num_classes)
        self.num_classes = num_classes

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (B, H, W, 3) -> dict of NHWC heads at stride 4."""
        dtype = next(self.parameters()).dtype
        x = image.to(dtype).permute(0, 3, 1, 2)
        return self.head(self.neck(self.backbone(x)))

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
                _truncated_normal(m.kernel, 2.0, kh * kw * cin, generator)
            elif id(m) in offset:
                nn.init.zeros_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # Conv2d weight (O, I, kh, kw), ConvTranspose2d (I, O, kh,
                # kw): fan_in = I*kh*kw either way
                i = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d)
                                   else 1]
                fan_in = i * m.weight.shape[2] * m.weight.shape[3]
                _truncated_normal(m.weight, 2.0 if id(m) in he else 1.0,
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


def _truncated_normal(t: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
