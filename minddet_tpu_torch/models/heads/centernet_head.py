"""CenterNet detection head: hm / wh / reg branches over the stride-4 map
(counterpart of ``minddet_tpu/models/heads/centernet_head.py``).

Each branch is Conv3x3 (``head_conv`` wide) -> ReLU -> Conv1x1; the
heatmap branch's last bias starts at ``hm_bias`` and its output goes
through ``sigmoid_clip`` in f32; wh and reg stay in the compute dtype;
without ``reg_offset`` there is no reg branch. Takes NCHW, returns NHWC
heads as the reference does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d
from minddet_tpu_torch.models.losses import sigmoid_clip


HM_BIAS = -2.19  # prior probability ~0.1


class _Branch(nn.Module):
    def __init__(self, in_channels: int, out_features: int, head_conv: int,
                 final_bias: float = 0.0):
        super().__init__()
        self.conv = Conv2d(in_channels, head_conv, 3, padding=1)
        self.out = Conv2d(head_conv, out_features, 1)
        self.final_bias = final_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.conv(x)))


class CenterNetHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80,
                 head_conv: int = 64, reg_offset: bool = True,
                 hm_bias: float = HM_BIAS):
        super().__init__()
        self.hm = _Branch(in_channels, num_classes, head_conv, hm_bias)
        self.wh = _Branch(in_channels, 2, head_conv)
        self.reg = _Branch(in_channels, 2, head_conv) if reg_offset else None

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        out = {"hm": sigmoid_clip(nhwc(self.hm(x)).float()),
               "wh": nhwc(self.wh(x))}
        if self.reg is not None:
            out["reg"] = nhwc(self.reg(x))
        return out
