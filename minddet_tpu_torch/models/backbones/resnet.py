"""ResNet backbone with optional DCNv2 stages (counterpart of
``minddet_tpu/models/backbones/resnet.py``).

Depth 18 (``BasicBlock``) only for now; ``Bottleneck`` and the scan path
come later. NCHW in ``channels_last`` memory; BN uses the batch's
statistics in train mode and the running ones in eval mode; convs compute
in their input's dtype (``models/layers.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import (BN_EPS, BatchNorm, Conv2d,
                                             ModulatedDeformConv)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dcn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=strides,
                               padding=1, bias=False)
        self.bn1 = BatchNorm(features, eps=BN_EPS)
        self.conv2 = (ModulatedDeformConv(features, features) if dcn else
                      Conv2d(features, features, 3, padding=1, bias=False))
        self.bn2 = BatchNorm(features, eps=BN_EPS)
        if strides != 1 or in_channels != features:
            # flax "SAME" pads a 1x1 stride-s conv by 0
            self.downsample_conv = Conv2d(in_channels, features, 1,
                                             stride=strides, bias=False)
            self.downsample_bn = BatchNorm(features, eps=BN_EPS)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


_ARCH = {18: (BasicBlock, (2, 2, 2, 2))}
WIDTHS = (64, 128, 256, 512)


class ResNet(nn.Module):
    """Multi-scale ResNet; returns (C2, C3, C4, C5). ``dcn_stages`` marks the
    stages whose blocks' ``conv2`` is a DCNv2 layer (``ModulatedDeformConv``,
    3x3, stride 1, width to width). CenterNet's are stages 2-4, whose 128,
    256 and 512 channels take the tap-grouped sampler; with
    ``dcn_stages[0]`` on, stage 1's ``layer1_*.conv2`` are 64 -> 64 DCN
    layers, and 64 channels take the flat sampler (``ops/dcn.py``)."""

    def __init__(self, depth: int = 18,
                 dcn_stages: Sequence[bool] = (False, False, False, False)):
        super().__init__()
        if depth not in _ARCH:
            raise NotImplementedError(
                f"depth {depth}: only {sorted(_ARCH)} is ported so far")
        block_cls, layers = _ARCH[depth]
        self.conv1 = Conv2d(3, WIDTHS[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm(WIDTHS[0], eps=BN_EPS)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.stage_names = []
        cin = WIDTHS[0]
        for stage, (width, n_blocks) in enumerate(zip(WIDTHS, layers)):
            names = []
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                strides = 2 if (stage > 0 and i == 0) else 1
                self.add_module(name, block_cls(
                    cin, width, strides=strides, dcn=dcn_stages[stage]))
                cin = width
                names.append(name)
            self.stage_names.append(tuple(names))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outputs = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            outputs.append(x)
        return tuple(outputs)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return WIDTHS
