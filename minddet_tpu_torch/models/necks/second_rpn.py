"""SECOND-style RPN (counterpart of
``minddet_tpu/models/necks/second_rpn.py``): per block a strided 3x3 down
conv + BN + ReLU, ``layer_nums[i]`` 3x3 conv + BN + ReLU layers, and an
upsampling ``ConvTranspose`` (kernel = stride) + BN + ReLU; the upsampled
maps are concatenated on channels.

NCHW in ``channels_last`` memory. BN has SECOND's eps 1e-3 and flax
momentum 0.99 (torch momentum 0.01). Module names are the flax scopes
(``block{i}_down_conv``, ``block{i}_{j}_conv``, ``up{i}_deconv``, ...), so
``utils/convert.py`` carries the JAX model's variables over.

The reference's TPU layout variants are not switches here: the
space-to-depth input with block0 as a 2x2 conv (``input_space_to_depth``),
the scanned and pre-stacked inner layers (``scan_inner``,
``stacked_inner``) and the zero-extended block0 kernel over a 65th canvas
channel all compute this same function (its tests pin them equal), and the
port runs the plain form.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from minddet_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # flax momentum 0.99


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class SECONDRPN(nn.Module):
    def __init__(self, in_channels: int = 64,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (64, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filters: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        cin = in_channels
        for bi, (n, s, f, us, uf) in enumerate(zip(
                layer_nums, layer_strides, num_filters, upsample_strides,
                num_upsample_filters)):
            if us < 1 or us != int(us):
                raise NotImplementedError(
                    f"upsample stride {us}: only whole strides (transposed "
                    "convs) are ported")
            us = int(us)
            self.add_module(f"block{bi}_down_conv",
                            Conv2d(cin, f, 3, stride=s, padding=1,
                                   bias=False))
            self.add_module(f"block{bi}_down_bn", _bn(f))
            for li in range(n):
                self.add_module(f"block{bi}_{li}_conv",
                                Conv2d(f, f, 3, padding=1, bias=False))
                self.add_module(f"block{bi}_{li}_bn", _bn(f))
            self.add_module(f"up{bi}_deconv",
                            ConvTranspose2d(f, uf, us, stride=us,
                                            bias=False))
            self.add_module(f"up{bi}_bn", _bn(uf))
            cin = f
        self.out_channels = sum(num_upsample_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, ny, nx) -> (B, sum(up filters), ny/s0, nx/s0)."""
        ups = []
        for bi, n in enumerate(self.layer_nums):
            x = torch.relu(getattr(self, f"block{bi}_down_bn")(
                getattr(self, f"block{bi}_down_conv")(x)))
            for li in range(n):
                x = torch.relu(getattr(self, f"block{bi}_{li}_bn")(
                    getattr(self, f"block{bi}_{li}_conv")(x)))
            ups.append(torch.relu(getattr(self, f"up{bi}_bn")(
                getattr(self, f"up{bi}_deconv")(x))))
        return torch.cat(ups, dim=1)
