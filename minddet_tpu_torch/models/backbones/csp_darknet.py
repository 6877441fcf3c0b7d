"""CSPDarknet backbone, YOLOv5/YOLOX style and the C2f variant of YOLOv8,
and YOLOv4's Mish ``CSPDarknet53`` (counterpart of
``minddet_tpu/models/backbones/csp_darknet.py``; its ``_CSP53Stage`` is
``CSP53Stage`` here).

NCHW in ``channels_last`` memory; convs compute in their input's dtype
(``models/layers.py``). Every BN is flax's ``BatchNorm(momentum=0.97,
epsilon=1e-3)``: torch momentum 0.03, eps 1e-3, in the SiLU blocks and
in the Mish ones alike. Module names mirror the flax
scopes (``stem/conv``, ``stage1/in``, ``b0/c1``, ``sppf/out``), so
``utils/convert.py:load_from_flax`` carries the weights across. Returns
(C3, C4, C5) at strides 8, 16 and 32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.layers import BatchNorm, Conv2d

BN_MOMENTUM = 0.03  # flax's 0.97
BN_EPS = 1e-3


class ConvBlock(nn.Module):
    """conv (no bias, padding kernel // 2) -> BN -> SiLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride=strides,
                           padding=kernel // 2, bias=False)
        self.bn = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two ConvBlocks of ``kernels`` ((1, 3) in CSP blocks, (3, 3) in C2f),
    plus the input where ``shortcut`` and the widths match."""

    def __init__(self, in_channels: int, features: int,
                 shortcut: bool = True, kernels: Tuple[int, int] = (1, 3)):
        super().__init__()
        k1, k2 = kernels
        self.c1 = ConvBlock(in_channels, features, k1)
        self.c2 = ConvBlock(features, features, k2)
        self.residual = shortcut and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        return y + x if self.residual else y


class CSPLayer(nn.Module):
    """Cross-stage partial block (YOLOv5's C3): ``main`` through ``n``
    Bottlenecks, concatenated with ``skip``, then ``out``."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        h = features // 2
        self.main = ConvBlock(in_channels, h, 1)
        self.skip = ConvBlock(in_channels, h, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"b{i}", Bottleneck(h, h, shortcut))
        self.out = ConvBlock(2 * h, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.main(x)
        for i in range(self.n):
            a = getattr(self, f"b{i}")(a)
        return self.out(torch.cat([a, self.skip(x)], dim=1))


class C2f(nn.Module):
    """YOLOv8's C2f: one ``in`` conv split in two halves, ``n`` (3, 3)
    Bottlenecks chained on the last part, every part concatenated into
    ``out``."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        h = features // 2
        self.h = h
        self.n = n
        # "in" is the flax scope's name (a Python keyword: no attribute)
        self.add_module("in", ConvBlock(in_channels, 2 * h, 1))
        for i in range(n):
            self.add_module(f"b{i}", Bottleneck(h, h, shortcut, (3, 3)))
        self.out = ConvBlock((2 + n) * h, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, "in")(x)
        parts = [y[:, :self.h], y[:, self.h:]]
        for i in range(self.n):
            parts.append(getattr(self, f"b{i}")(parts[-1]))
        return self.out(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """``in`` to half the width, three chained ``pool`` x ``pool`` stride-1
    max pools (padding with -inf, as flax's), the four maps concatenated
    into ``out``."""

    def __init__(self, in_channels: int, features: int, pool: int = 5):
        super().__init__()
        h = features // 2
        self.pool = pool
        self.add_module("in", ConvBlock(in_channels, h, 1))
        self.out = ConvBlock(4 * h, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, "in")(x)
        p = self.pool
        y1 = F.max_pool2d(x, p, 1, p // 2)
        y2 = F.max_pool2d(y1, p, 1, p // 2)
        y3 = F.max_pool2d(y2, p, 1, p // 2)
        return self.out(torch.cat([x, y1, y2, y3], dim=1))


class CSPDarknet(nn.Module):
    """depth / width multipliers: s = (0.33, 0.5), m = (0.67, 0.75), l = (1,
    1). ``use_c2f`` takes YOLOv8's C2f blocks, else CSPLayers; ``depths``
    overrides the four stage block counts before the depth multiplier
    (default (3, 6, 6, 3) with C2f, (3, 9, 9, 3) without)."""

    def __init__(self, depth_mult: float = 0.33, width_mult: float = 0.5,
                 use_c2f: bool = False,
                 depths: Optional[Sequence[int]] = None):
        super().__init__()

        def w(c):
            return max(16, int(c * width_mult // 8 * 8))

        def d(n):
            return max(1, round(n * depth_mult))

        deep = 6 if use_c2f else 9
        n1, n2, n3, n4 = depths or (3, deep, deep, 3)
        block = C2f if use_c2f else CSPLayer
        self.stem = ConvBlock(3, w(64), 3, 2)
        self.down1 = ConvBlock(w(64), w(128), 3, 2)
        self.stage1 = block(w(128), w(128), d(n1))
        self.down2 = ConvBlock(w(128), w(256), 3, 2)
        self.stage2 = block(w(256), w(256), d(n2))
        self.down3 = ConvBlock(w(256), w(512), 3, 2)
        self.stage3 = block(w(512), w(512), d(n3))
        self.down4 = ConvBlock(w(512), w(1024), 3, 2)
        self.stage4 = block(w(1024), w(1024), d(n4))
        self.sppf = SPPF(w(1024), w(1024))
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stage1(self.down1(self.stem(x)))
        c3 = self.stage2(self.down2(x))
        c4 = self.stage3(self.down3(c3))
        c5 = self.sppf(self.stage4(self.down4(c4)))
        return c3, c4, c5


def mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x)) (flax's ``softplus`` is ``logaddexp(x, 0)``;
    torch's takes x itself past 20, which moves neither the value nor the
    gradient beyond f64 rounding there)."""
    return F.mish(x)


class MishConv(nn.Module):
    """conv (no bias, padding kernel // 2) -> BN -> Mish: YOLOv4's block."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride=strides,
                           padding=kernel // 2, bias=False)
        self.bn = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(self.bn(self.conv(x)))


class CSP53Stage(nn.Module):
    """One CSPDarknet53 stage: ``main`` and ``skip`` 1x1 to h (half the
    width where ``n`` > 1, the whole width for the single-block stage),
    ``n`` residual (1x1 to h / 2 (h where ``n`` is 1), 3x3 to h)
    bottlenecks ``b{i}_c1`` / ``b{i}_c2`` on ``main``, then ``post``, the
    concatenation with ``skip`` and the 1x1 ``out``; Mish throughout."""

    def __init__(self, in_channels: int, features: int, n: int):
        super().__init__()
        h = features // 2 if n > 1 else features
        inner = h // 2 if n > 1 else h
        self.n = n
        self.main = MishConv(in_channels, h, 1)
        self.skip = MishConv(in_channels, h, 1)
        for i in range(n):
            self.add_module(f"b{i}_c1", MishConv(h, inner, 1))
            self.add_module(f"b{i}_c2", MishConv(inner, h, 3))
        self.post = MishConv(h, h, 1)
        self.out = MishConv(2 * h, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.main(x)
        for i in range(self.n):
            a = a + getattr(self, f"b{i}_c2")(getattr(self, f"b{i}_c1")(a))
        return self.out(torch.cat([self.post(a), self.skip(x)], dim=1))


class CSPDarknet53(nn.Module):
    """YOLOv4's backbone: a 3x3 ``stem``, then five stages, each a 3x3
    stride-2 ``down{s}`` and a ``CSP53Stage`` ``stage{s}`` of Darknet-53's
    residual counts (1, 2, 8, 8, 4) at (64, 128, 256, 512, 1024) scaled by
    ``width_mult``. Returns the last three stages' maps (C3, C4, C5) at
    strides 8, 16 and 32."""

    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self, width_mult: float = 1.0):
        super().__init__()

        def w(c):
            return max(16, int(c * width_mult // 8 * 8))

        self.stem = MishConv(3, w(32), 3)
        cin = w(32)
        for si, (c, n) in enumerate(self.STAGES):
            self.add_module(f"down{si}", MishConv(cin, w(c), 3, 2))
            self.add_module(f"stage{si}", CSP53Stage(w(c), w(c), n))
            cin = w(c)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        outs = []
        for si in range(len(self.STAGES)):
            x = getattr(self, f"stage{si}")(getattr(self, f"down{si}")(x))
            outs.append(x)
        return outs[2], outs[3], outs[4]
