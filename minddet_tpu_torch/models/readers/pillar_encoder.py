"""The stream Pillar Feature Network (counterpart of the stream path of
``minddet_tpu/models/readers/pillar_encoder.py``): the decorated point
stream (B, N, Cin) -> Linear -> masked BN -> ReLU -> the pillar's running
max, so that each pillar's last kept row holds its feature.

A non-last layer (CenterPoint's ``pfn_filters=(64, 64)`` has one) emits
half its width and concatenates each pillar's max back onto every kept
point of the pillar, through ``ops/seg_max.py:seg_full_max_bounded``.

BN follows the module's mode: in train mode the statistics are those of the
kept points of the batch, and the gradient flows through them. ``dtype`` is
the compute dtype over f32 parameters, as in flax.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from minddet_tpu_torch.models.layers import Linear
from minddet_tpu_torch.ops.seg_max import seg_full_max_bounded
from minddet_tpu_torch.ops.voxelize import seg_running_max


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis whose statistics cover only the valid
    positions. ``weight``, ``bias``, ``running_mean`` and ``running_var``
    carry flax's ``scale``, ``bias``, ``mean`` and ``var``.

    The statistics (the running ones in eval, the batch's in train mode)
    and the affine fold into ``x * a + b`` in the input's dtype, as the
    reference computes it. Train mode takes the mean and the biased
    variance ``max(E[x^2] - mean^2, 0)`` over the positions where ``mask``
    is set (all of them for ``mask=None``) in one pass of f32 sums (f64 for
    an f64 input), lets the gradient flow through them, and updates the
    running statistics in place: ``ra = (1 - momentum) * ra + momentum *
    stat``, ``momentum`` in torch's sense (0.01 is flax's 0.99)."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _batch_stats(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        stat = torch.promote_types(x.dtype, torch.float32)
        red = tuple(range(x.dim() - 1))
        if mask is None:
            count = x.numel() // x.shape[-1]
            xm = x
        else:
            count = mask.sum(dtype=torch.float32).clamp(min=1.0)
            xm = x * mask[..., None].to(x.dtype)
        mean = xm.sum(dim=red, dtype=stat) / count
        xf = xm.to(stat)
        var = ((xf * xf).sum(dim=red) / count - mean * mean).clamp(min=0.0)
        return mean, var

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., C); ``mask`` broadcastable to ``x[..., 0]``, read in train
        mode only."""
        if self.training:
            mean, var = self._batch_stats(x, mask)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                        self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype),
                                       self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        root = torch.sqrt(var + self.eps)
        a = (self.weight / root).to(x.dtype)
        b = (self.bias - mean * self.weight / root).to(x.dtype)
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
        self.linear = Linear(in_features, units, bias=False)
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
        x = torch.relu(self.norm(self.linear(x), keep))
        x = x * keep[..., None].to(x.dtype)
        if self.last_layer:
            return seg_running_max(first, x, bound)
        return torch.cat([x, seg_full_max_bounded(first, last, x, bound)],
                         dim=-1)


class PillarFeatureNet(nn.Module):
    """Stacked ``PFNLayer``s named ``pfn{i}``, as the flax scopes are."""

    def __init__(self, in_features: int = 9,
                 num_filters: Sequence[int] = (64,),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
        C), computed in ``dtype``."""
        x = feats.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}").stream(x, keep, first, last, bound)
        return x
