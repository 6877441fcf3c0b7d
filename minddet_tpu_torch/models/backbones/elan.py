"""E-ELAN backbone of YOLOv7 (counterpart of
``minddet_tpu/models/backbones/elan.py``: ``ELANBlock``, ``MPDown`` and
``ELANNet``).

NCHW in ``channels_last`` memory, every conv a ``ConvBlock`` of
``csp_darknet.py`` (BN momentum 0.97 in flax's terms, eps 1e-3, SiLU).
Module names mirror the flax scopes. Returns (C3, C4, C5) at strides 8, 16
and 32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import ConvBlock

TAPS = 2  # pairs of 3x3 convs in every ELAN block of YOLOv7


class ELANBlock(nn.Module):
    """Two 1x1 entries ``in_a`` and ``in_b`` at ``hidden``; ``TAPS`` pairs
    of 3x3 convs ``t{t}_0`` / ``t{t}_1`` chained on ``in_b``'s output, each
    pair's output tapped; the entries and the taps concatenated into the
    1x1 ``out`` at ``features``."""

    def __init__(self, in_channels: int, features: int, hidden: int):
        super().__init__()
        self.in_a = ConvBlock(in_channels, hidden, 1)
        self.in_b = ConvBlock(in_channels, hidden, 1)
        for t in range(TAPS):
            self.add_module(f"t{t}_0", ConvBlock(hidden, hidden, 3))
            self.add_module(f"t{t}_1", ConvBlock(hidden, hidden, 3))
        self.out = ConvBlock((2 + TAPS) * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.in_b(x)
        parts = [self.in_a(x), y]
        for t in range(TAPS):
            y = getattr(self, f"t{t}_1")(getattr(self, f"t{t}_0")(y))
            parts.append(y)
        return self.out(torch.cat(parts, dim=1))


class MPDown(nn.Module):
    """YOLOv7's downsample to half the size: a 2x2 stride-2 max pool then
    the 1x1 ``pool_proj``, beside the 1x1 ``pre`` then the 3x3 stride-2
    ``down``, each at half of ``features``, concatenated (pool branch
    first)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        h = features // 2
        self.pool_proj = ConvBlock(in_channels, h, 1)
        self.pre = ConvBlock(in_channels, h, 1)
        self.down = ConvBlock(h, h, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pool_proj(F.max_pool2d(x, 2, 2))
        return torch.cat([p, self.down(self.pre(x))], dim=1)


class ELANNet(nn.Module):
    """YOLOv7's backbone: the stem ``stem0`` (3x3), ``stem1`` (3x3 stride
    2), ``stem2`` (3x3), ``down1`` (3x3 stride 2), then ELAN stages with
    ``MPDown`` between them; widths of YOLOv7-l's plan scaled by
    ``width_mult`` (C3 / C4 / C5 = 512 / 1024 / 1024 before it)."""

    def __init__(self, width_mult: float = 0.5):
        super().__init__()

        def w(c):
            return max(16, int(c * width_mult // 8 * 8))

        self.stem0 = ConvBlock(3, w(32), 3)
        self.stem1 = ConvBlock(w(32), w(64), 3, 2)
        self.stem2 = ConvBlock(w(64), w(64), 3)
        self.down1 = ConvBlock(w(64), w(128), 3, 2)
        self.stage1 = ELANBlock(w(128), w(256), w(64))
        self.mp2 = MPDown(w(256), w(256))
        self.stage2 = ELANBlock(w(256), w(512), w(128))
        self.mp3 = MPDown(w(512), w(512))
        self.stage3 = ELANBlock(w(512), w(1024), w(256))
        self.mp4 = MPDown(w(1024), w(1024))
        self.stage4 = ELANBlock(w(1024), w(1024), w(256))
        self.out_channels = (w(512), w(1024), w(1024))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.down1(self.stem2(self.stem1(self.stem0(x))))
        c3 = self.stage2(self.mp2(self.stage1(x)))
        c4 = self.stage3(self.mp3(c3))
        c5 = self.stage4(self.mp4(c4))
        return c3, c4, c5
