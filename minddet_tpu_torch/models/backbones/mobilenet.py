"""MobileNetV2 with SSD's two taps (counterpart of
``minddet_tpu/models/backbones/mobilenet.py``: ``InvertedResidual`` and
``MobileNetV2``).

NCHW in ``channels_last`` memory. Every BN is flax's ``BatchNorm(momentum=
0.9)`` at its default epsilon: torch momentum 0.1, eps 1e-5 (not the CSP
blocks' 0.03 and 1e-3). Module names mirror the flax scopes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.layers import BN_EPS, BatchNorm, Conv2d

BN_MOMENTUM = 0.1  # flax's 0.9
WIDTH = 1.0  # the width multiplier of SSD's config

# (expand, channels, repeats, stride) of MobileNetV2's seven block groups
MBV2_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def bn(features: int) -> BatchNorm:
    """flax's ``BatchNorm(momentum=0.9)`` at eps 1e-5."""
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class InvertedResidual(nn.Module):
    """MobileNetV2's block: a 1x1 ``expand`` to ``expand`` x the input's
    width (none at ``expand`` 1), a depthwise 3x3 ``dw`` at ``strides``, a
    1x1 ``project`` to ``features``, each followed by its BN, ReLU6 after
    the first two; the input added where the stride is 1 and the widths
    match."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 expand: int = 6):
        super().__init__()
        hidden = in_channels * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = Conv2d(in_channels, hidden, 1, bias=False)
            self.expand_bn = bn(hidden)
        self.dw = Conv2d(hidden, hidden, 3, stride=strides, padding=1,
                         groups=hidden, bias=False)
        self.dw_bn = bn(hidden)
        self.project = Conv2d(hidden, features, 1, bias=False)
        self.project_bn = bn(features)
        self.residual = strides == 1 and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.has_expand:
            y = F.relu6(self.expand_bn(self.expand(y)))
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.project_bn(self.project(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """The ``stem`` (3x3 stride 2), blocks ``block0`` to ``block16`` of
    ``MBV2_CFG``, the 1x1 ``head`` to 1280, each conv with its BN and
    ReLU6; widths ``ch(c) = max(8, int(c w + 4) // 8 * 8)`` at ``w`` =
    ``WIDTH``. Returns (C4,
    C5): the stride-16 map entering block 13 (group 5's first block, the
    downsample) and the head's stride-32 map."""

    def __init__(self):
        super().__init__()

        def ch(c):
            return max(8, int(c * WIDTH + 4) // 8 * 8)

        self.stem = Conv2d(3, ch(32), 3, stride=2, padding=1, bias=False)
        self.stem_bn = bn(ch(32))
        cin, block = ch(32), 0
        self.c4_block = None
        for bi, (t, c, n, s) in enumerate(MBV2_CFG):
            for i in range(n):
                if bi == 5 and i == 0:
                    self.c4_block = block
                    self.c4_channels = cin
                self.add_module(f"block{block}", InvertedResidual(
                    cin, ch(c), s if i == 0 else 1, t))
                cin, block = ch(c), block + 1
        self.blocks = block
        self.head = Conv2d(cin, ch(1280), 1, bias=False)
        self.head_bn = bn(ch(1280))
        self.out_channels = (self.c4_channels, ch(1280))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu6(self.stem_bn(self.stem(x)))
        c4 = None
        for i in range(self.blocks):
            if i == self.c4_block:
                c4 = x
            x = getattr(self, f"block{i}")(x)
        return c4, F.relu6(self.head_bn(self.head(x)))
