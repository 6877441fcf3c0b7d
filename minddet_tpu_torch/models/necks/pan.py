"""The YOLO family's path-aggregation necks (counterpart of
``minddet_tpu/models/necks/pan.py``: ``_up2``, ``PAN`` and ``C2fPAN``).

NCHW in ``channels_last`` memory; the reference's channel concatenations on
the last NHWC axis are concatenations on dim 1 here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import (C2f, ConvBlock,
                                                             CSPLayer)


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling (the reference's ``jax.image.resize
    (..., "nearest")`` to twice the size: each pixel repeated 2 x 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAN(nn.Module):
    """YOLOX's and YOLOv5's neck: top-down with lateral 1x1 reduces
    (``reduce5`` to P5 at ``w4``, ``reduce4`` to P4 at ``w3``), then
    bottom-up; CSPLayers without shortcut at ``depth`` fuse
    [up2(P5), C4] (``td4``), [up2(P4), C3] (``td3``), [down3(N3), P4]
    (``bu4``) and [down4(N4), P5] (``bu5``); ``down3`` and ``down4`` are
    3x3 stride-2 ConvBlocks. Returns (N3, N4, N5) of ``out_channels``."""

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (128, 256, 512),
                 depth: int = 1):
        super().__init__()
        c3, c4, c5 = in_channels
        w3, w4, w5 = out_channels
        self.reduce5 = ConvBlock(c5, w4, 1)
        self.td4 = CSPLayer(w4 + c4, w4, depth, False)
        self.reduce4 = ConvBlock(w4, w3, 1)
        self.td3 = CSPLayer(w3 + c3, w3, depth, False)
        self.down3 = ConvBlock(w3, w3, 3, 2)
        self.bu4 = CSPLayer(2 * w3, w4, depth, False)
        self.down4 = ConvBlock(w4, w4, 3, 2)
        self.bu5 = CSPLayer(2 * w4, w5, depth, False)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c3, c4, c5 = feats
        p5 = self.reduce5(c5)
        p4 = self.reduce4(self.td4(torch.cat([up2(p5), c4], dim=1)))
        n3 = self.td3(torch.cat([up2(p4), c3], dim=1))
        n4 = self.bu4(torch.cat([self.down3(n3), p4], dim=1))
        n5 = self.bu5(torch.cat([self.down4(n4), p5], dim=1))
        return n3, n4, n5


class C2fPAN(nn.Module):
    """Ultralytics YOLOv8's neck: top-down then bottom-up C2f fusion with no
    lateral reduce convs, the backbone's (C3, C4, C5) concatenated straight
    into ``td4``, ``td3``, ``bu4`` and ``bu5``; ``down3`` and ``down4`` are
    3x3 stride-2 ConvBlocks. C2f blocks without shortcut. Returns (N3, N4,
    N5) of ``out_channels``."""

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (128, 256, 512),
                 depth: int = 1):
        super().__init__()
        c3, c4, c5 = in_channels
        w3, w4, w5 = out_channels
        self.td4 = C2f(c5 + c4, w4, depth, False)
        self.td3 = C2f(w4 + c3, w3, depth, False)
        self.down3 = ConvBlock(w3, w3, 3, 2)
        self.bu4 = C2f(w3 + w4, w4, depth, False)
        self.down4 = ConvBlock(w4, w4, 3, 2)
        self.bu5 = C2f(w4 + c5, w5, depth, False)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c3, c4, c5 = feats
        m4 = self.td4(torch.cat([up2(c5), c4], dim=1))
        n3 = self.td3(torch.cat([up2(m4), c3], dim=1))
        n4 = self.bu4(torch.cat([self.down3(n3), m4], dim=1))
        n5 = self.bu5(torch.cat([self.down4(n4), c5], dim=1))
        return n3, n4, n5
