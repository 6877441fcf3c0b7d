"""The stream Pillar Feature Network, in eval (counterpart of the stream
path of ``minddet_tpu/models/readers/pillar_encoder.py``): the decorated
point stream (B, N, Cin) -> Linear -> masked BN -> ReLU -> the pillar's
running max, so that each pillar's last kept row holds its feature.

A non-last layer (CenterPoint's ``pfn_filters=(64, 64)`` has one) emits
half its width and concatenates each pillar's max back onto every kept
point of the pillar, through ``ops/seg_max.py:seg_full_max_bounded``.
Training (masked BN batch statistics) is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from minddet_tpu_torch.ops.seg_max import seg_full_max_bounded
from minddet_tpu_torch.ops.voxelize import seg_running_max


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid points only, in eval: the running
    statistics and the affine fold into ``x * a + b`` in the input's dtype,
    as the reference computes it. ``weight``, ``bias``, ``running_mean``
    and ``running_var`` carry flax's ``scale``, ``bias``, ``mean`` and
    ``var``."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm: only eval is ported (the PointPillars "
                "train step is a later slice)")
        root = torch.sqrt(self.running_var + self.eps)
        a = (self.weight / root).to(x.dtype)
        b = (self.bias - self.running_mean * self.weight / root).to(x.dtype)
        return x * a + b


class PFNLayer(nn.Module):
    """Linear (no bias) -> masked BN -> ReLU -> pillar max: the running max
    in the last layer; in a non-last layer (half width) the full max,
    concatenated onto each point's own features."""

    def __init__(self, in_features: int, out_features: int,
                 last_layer: bool = True):
        super().__init__()
        self.last_layer = last_layer
        units = out_features if last_layer else out_features // 2
        self.linear = nn.Linear(in_features, units, bias=False)
        self.norm = MaskedBatchNorm(units)

    def stream(self, x: torch.Tensor, keep: torch.Tensor,
               first: torch.Tensor, last: torch.Tensor,
               bound: int) -> torch.Tensor:
        """Sorted stream (B, N, Cin) and its keep / segment-head / last-kept
        flags. Last layer -> (B, N, units): at each segment's last kept row
        the full pillar max over the kept points, exact because no kept row
        lies more than ``bound`` (the per-pillar point cap) rows past its
        head. Non-last layer -> (B, N, 2 * units): each point's features,
        then its pillar's max (at kept rows; other rows hold zeros there,
        and the next layer masks them)."""
        x = torch.relu(self.norm(self.linear(x)))
        x = x * keep[..., None].to(x.dtype)
        if self.last_layer:
            return seg_running_max(first, x, bound)
        return torch.cat([x, seg_full_max_bounded(first, last, x, bound)],
                         dim=-1)


class PillarFeatureNet(nn.Module):
    """Stacked ``PFNLayer``s named ``pfn{i}``, as the flax scopes are."""

    def __init__(self, in_features: int = 9,
                 num_filters: Sequence[int] = (64,)):
        super().__init__()
        self.num_layers = len(num_filters)
        cin = in_features
        for i, nf in enumerate(num_filters):
            last = i == len(num_filters) - 1
            self.add_module(f"pfn{i}", PFNLayer(cin, nf, last_layer=last))
            cin = nf if last else 2 * (nf // 2)
        self.out_channels = num_filters[-1]

    def stream(self, feats: torch.Tensor, keep: torch.Tensor,
               first: torch.Tensor, last: torch.Tensor,
               bound: int) -> torch.Tensor:
        """Decorated stream (B, N, Cin) -> running pillar features (B, N,
        C), computed in the layers' parameter dtype."""
        x = feats.to(self.pfn0.linear.weight.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}").stream(x, keep, first, last, bound)
        return x
