"""CenterNet deconvolution neck: C5 -> stride-4 feature map (counterpart of
``minddet_tpu/models/necks/ct_deconv.py``).

Three stages of (DCNv2 -> BN -> ReLU -> ConvTranspose 4x4 s2 -> BN -> ReLU)
with filters (256, 128, 64); NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

import torch
from torch import nn

from minddet_tpu_torch.models.layers import DeconvBlock


NUM_FILTERS = (256, 128, 64)


class CenterNetDeconvNeck(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        chans = (in_channels,) + NUM_FILTERS
        for i, f in enumerate(NUM_FILTERS):
            self.add_module(f"deconv{i}", DeconvBlock(chans[i], f))

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = x[-1]  # C5
        for i in range(len(NUM_FILTERS)):
            x = getattr(self, f"deconv{i}")(x)
        return x
