"""CenterNet detection head: hm / wh / reg branches over the stride-4 map
(counterpart of ``minddet_tpu/models/heads/centernet_head.py``).

Each branch is Conv3x3 -> ReLU -> Conv1x1; the heatmap branch's last bias
starts at -2.19 and its output goes through ``sigmoid_clip`` in f32; wh
and reg stay in the compute dtype. Takes NCHW, returns NHWC heads as the
reference does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d
from minddet_tpu_torch.models.losses import sigmoid_clip


HEAD_CONV = 64
HM_BIAS = -2.19  # prior probability ~0.1


class _Branch(nn.Module):
    def __init__(self, in_channels: int, out_features: int,
                 final_bias: float = 0.0):
        super().__init__()
        self.conv = Conv2d(in_channels, HEAD_CONV, 3, padding=1)
        self.out = Conv2d(HEAD_CONV, out_features, 1)
        self.final_bias = final_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.conv(x)))


class CenterNetHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.hm = _Branch(in_channels, num_classes, HM_BIAS)
        self.wh = _Branch(in_channels, 2)
        self.reg = _Branch(in_channels, 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {
            "hm": sigmoid_clip(nhwc(self.hm(x)).float()),
            "wh": nhwc(self.wh(x)),
            "reg": nhwc(self.reg(x)),
        }
