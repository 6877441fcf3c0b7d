"""ResNet backbone with optional DCNv2 stages (counterpart of
``minddet_tpu/models/backbones/resnet.py``).

Depths 18 and 34 (``BasicBlock``) and 50, 101 and 152 (``Bottleneck``).
In eval mode the reference runs each stage's inner Bottlenecks as one
``lax.scan`` over their stacked variables (``_scan_bottlenecks``), which
computes the same function; here they run one after another under their
per-block names ``layer{s}_{i}``. NCHW in ``channels_last`` memory; BN uses
the batch's statistics in train mode and the running ones in eval mode;
convs compute in their input's dtype (``models/layers.py``).
``output_stride`` 16 or 8 dilates the last one or two stages as the
reference does: the stage's dilation doubles before its first block, which
runs at stride 1 with the new dilation (torchvision's
``replace_stride_with_dilation`` gives that block the previous one), and
every 3x3 conv of the stage, both of a ``BasicBlock``'s, is dilated and
padded by it. The reference's DCN Bottlenecks are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import (BN_EPS, BatchNorm, Conv2d,
                                             ModulatedDeformConv)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dcn: bool = False, dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = Conv2d(in_channels, features, 3, stride=strides,
                            padding=d, dilation=d, bias=False)
        self.bn1 = BatchNorm(features, eps=BN_EPS)
        self.conv2 = (ModulatedDeformConv(features, features) if dcn else
                      Conv2d(features, features, 3, padding=d, dilation=d,
                             bias=False))
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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride and the dilation, ResNet v1.5) -> 1x1 to
    ``4 * features``, BN after each, ReLU after the first two and after the
    residual add; the downsample branch (1x1 with the stride, BN) wherever
    the output's shape differs from the input's, ``layer1_0`` (64 -> 256 at
    stride 1) included."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dcn: bool = False, dilation: int = 1):
        super().__init__()
        if dcn:
            raise NotImplementedError("DCN Bottlenecks are not ported")
        out = features * self.expansion
        self.conv1 = Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features, eps=BN_EPS)
        self.conv2 = Conv2d(features, features, 3, stride=strides,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn2 = BatchNorm(features, eps=BN_EPS)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, eps=BN_EPS)
        if strides != 1 or in_channels != out:
            self.downsample_conv = Conv2d(in_channels, out, 1,
                                          stride=strides, bias=False)
            self.downsample_bn = BatchNorm(out, eps=BN_EPS)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


_ARCH = {18: (BasicBlock, (2, 2, 2, 2)), 34: (BasicBlock, (3, 4, 6, 3)),
         50: (Bottleneck, (3, 4, 6, 3)), 101: (Bottleneck, (3, 4, 23, 3)),
         152: (Bottleneck, (3, 8, 36, 3))}
WIDTHS = (64, 128, 256, 512)
DILATED_STAGES = {32: 0, 16: 1, 8: 2}  # output stride -> stages dilated


class ResNet(nn.Module):
    """Multi-scale ResNet; returns (C2, C3, C4, C5). ``dcn_stages`` marks the
    stages whose blocks' ``conv2`` is a DCNv2 layer (``ModulatedDeformConv``,
    3x3, stride 1, width to width). CenterNet's are stages 2-4, whose 128,
    256 and 512 channels take the tap-grouped sampler; with
    ``dcn_stages[0]`` on, stage 1's ``layer1_*.conv2`` are 64 -> 64 DCN
    layers, and 64 channels take the flat sampler (``ops/dcn.py``).
    ``output_stride`` 16 dilates stage 4 (dilation 2), 8 stages 3 and 4 (2
    and 4): C4 and C5 then keep C3's or C4's size."""

    def __init__(self, depth: int = 18,
                 dcn_stages: Sequence[bool] = (False, False, False, False),
                 output_stride: int = 32):
        super().__init__()
        if depth not in _ARCH:
            raise ValueError(f"depth {depth}: one of {sorted(_ARCH)}")
        if output_stride not in DILATED_STAGES:
            raise ValueError(f"output_stride {output_stride}: one of "
                             f"{sorted(DILATED_STAGES)}")
        first_dilated = 4 - DILATED_STAGES[output_stride]
        block_cls, layers = _ARCH[depth]
        self.expansion = block_cls.expansion
        self.conv1 = Conv2d(3, WIDTHS[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm(WIDTHS[0], eps=BN_EPS)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.stage_names = []
        cin = WIDTHS[0]
        dilation = 1
        for stage, (width, n_blocks) in enumerate(zip(WIDTHS, layers)):
            dilate = stage >= first_dilated and stage > 0
            if dilate:
                dilation *= 2  # before the stage's first block
            names = []
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                strides = 2 if (stage > 0 and i == 0 and not dilate) else 1
                self.add_module(name, block_cls(
                    cin, width, strides=strides, dcn=dcn_stages[stage],
                    dilation=dilation))
                cin = width * self.expansion
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
        return tuple(w * self.expansion for w in WIDTHS)

    def he_convs(self):
        """The convs the reference draws He-normal: the stem's and every
        ``BasicBlock``'s (its ``Bottleneck`` convs keep flax's
        LeCun-normal default)."""
        return [self.conv1] + [m for blk in self.modules()
                               if isinstance(blk, BasicBlock)
                               for m in blk.modules()
                               if isinstance(m, nn.Conv2d)]
