"""Shared building blocks (counterpart of ``minddet_tpu/models/layers.py``).

Modules take and return NCHW tensors kept in ``torch.channels_last`` memory,
so the NHWC view the DCN sampler reads (``x.permute(0, 2, 3, 1)``) is
already contiguous and costs no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from minddet_tpu_torch.ops.dcn import deform_conv2d

BN_EPS = 1e-5


class ModulatedDeformConv(nn.Module):
    """DCNv2 layer: offset/mask conv + deformable sampling conv.

    ``conv_offset`` emits 3K channels: [0, 2K) reshape to (K, 2) as (dy, dx),
    [2K, 3K) are the mask logits (the reference's layout, not mmcv's).
    ``kernel`` keeps the reference's (kh, kw, Cin, Cout) layout, which the
    contraction reshapes to (K*Cin, Cout). 3x3, stride 1, padding 1, no
    bias: the only form the CenterNet path uses.
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv_offset = nn.Conv2d(in_channels, 3 * 9, 3, padding=1)
        self.kernel = nn.Parameter(torch.empty(3, 3, in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = 9
        off_mask = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 3K)
        b, ho, wo, _ = off_mask.shape
        offsets = off_mask[..., :2 * k].reshape(b, ho, wo, k, 2)
        mask = torch.sigmoid(off_mask[..., 2 * k:])
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, mask, self.kernel)
        return y.permute(0, 3, 1, 2)


class DeconvBlock(nn.Module):
    """DCN 3x3 -> BN -> ReLU -> ConvTranspose k4 s2 -> BN -> ReLU.

    The transposed conv is torch's ``ConvTranspose2d(k=4, s=2, p=1)``, which
    equals flax's ``ConvTranspose`` (SAME padding (2, 2), no kernel flip)
    with the kernel flipped spatially (``utils/convert.py``).
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.dcn = ModulatedDeformConv(in_channels, features)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.up = nn.ConvTranspose2d(features, features, 4, stride=2,
                                     padding=1)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.dcn(x)))
        return torch.relu(self.bn2(self.up(x)))
