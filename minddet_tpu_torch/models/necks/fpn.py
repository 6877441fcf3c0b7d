"""Feature Pyramid Network neck (counterpart of
``minddet_tpu/models/necks/fpn.py``, its max-pool extra levels).

NCHW in ``channels_last`` memory: the 1x1 laterals, the nearest 2x
upsample, the adds and the 3x3 smooth convs all keep it, so each output's
NHWC view (what ROIAlign's gather reads) is contiguous without a copy.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d


class FPN(nn.Module):
    """Lateral 1x1 convs, top-down nearest 2x upsample and add, 3x3 smooth
    convs; ``extra_levels`` more levels, each the last one subsampled by 2
    (the reference's ``max_pool`` with a 1x1 window and stride 2)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 extra_levels: int = 1):
        super().__init__()
        self.num_levels = len(in_channels)
        self.extra_levels = extra_levels
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"smooth{i}", Conv2d(out_channels, out_channels,
                                                 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + F.interpolate(
                laterals[i + 1], scale_factor=2, mode="nearest")
        outs = [getattr(self, f"smooth{i}")(x)
                for i, x in enumerate(laterals)]
        last = outs[-1]
        for _ in range(self.extra_levels):
            last = last[:, :, ::2, ::2]
            outs.append(last)
        return outs
