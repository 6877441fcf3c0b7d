"""The Pillar Feature Network and the canvas scatter (counterpart of
``minddet_tpu/models/readers/pillar_encoder.py``). Each layer is Linear ->
masked BN -> ReLU -> the pillar's max, in two forms that compute the same
pillar features from one set of parameters:

- padded (``forward``): decorated voxels (B, V, P, Cin) and the point mask
  -> the max over each voxel's P slots; ``PillarFeatureNet.forward`` gives
  (B, V, C) and ``scatter_voxel_canvas`` puts it on the BEV canvas;
- stream (``stream``): the decorated point stream (B, N, Cin) -> the
  pillar's running max, so that each pillar's last kept row holds its
  feature (``ops/voxelize.py:scatter_stream_canvas`` builds the canvas).

A non-last layer (CenterPoint's ``pfn_filters=(64, 64)`` has one) emits
half its width and concatenates each pillar's max back onto every point
of the pillar: a broadcast in the padded form, the segment-max kernel
(``ops/seg_max.py:seg_full_max_bounded``) in the stream form.

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
from minddet_tpu_torch.ops.voxelize import seg_running_max, voxel_cell_rows


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

    def _dense_bn_relu(self, x: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm(self.linear(x), valid))
        return x * valid[..., None].to(x.dtype)

    def forward(self, x: torch.Tensor,
                point_mask: torch.Tensor) -> torch.Tensor:
        """Padded points (B, V, P, Cin) and their mask (B, V, P). Last layer
        -> (B, V, 1, units), the max over each voxel's slots (empty slots
        are 0 and every kept value is at least 0); non-last layer -> (B, V,
        P, 2 * units), each slot's features, then its voxel's max. A tie
        shares the max's gradient evenly, as ``jnp.max`` does."""
        x = self._dense_bn_relu(x, point_mask)
        x_max = x.amax(dim=2, keepdim=True)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)

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
        x = self._dense_bn_relu(x, keep)
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

    def forward(self, features: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        """Decorated voxels (B, V, P, Cin) and their point counts (B, V) ->
        pillar features (B, V, C), computed in ``dtype``."""
        mask = torch.arange(features.shape[2], device=features.device) \
            < num_points[..., None]
        x = features.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}")(x, mask)
        return x.squeeze(2)

    def stream(self, feats: torch.Tensor, keep: torch.Tensor,
               first: torch.Tensor, last: torch.Tensor,
               bound: int) -> torch.Tensor:
        """Decorated stream (B, N, Cin) -> running pillar features (B, N,
        C), computed in ``dtype``."""
        x = feats.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}").stream(x, keep, first, last, bound)
        return x


def scatter_voxel_canvas(pillars: torch.Tensor, coords: torch.Tensor,
                         ny: int, nx: int) -> torch.Tensor:
    """Pillar features (B, V, C) and their coords (B, V, 3) [gz, gy, gx]
    -> the BEV canvas (B, C, ny, nx) in ``channels_last`` memory (the
    reference's ``PointPillarsScatter``): one ``index_copy_`` of the
    voxels into B * ny * nx + 1 rows (``voxel_cell_rows``), the empty
    slots all to the last row, which is sliced off. One voxel per cell, so
    each canvas row is written once. Differentiable with respect to
    ``pillars``."""
    b, v, c = pillars.shape
    flat = torch.zeros(b * ny * nx + 1, c, dtype=pillars.dtype,
                       device=pillars.device)
    flat.index_copy_(0, voxel_cell_rows(coords, ny, nx).reshape(-1),
                     pillars.reshape(b * v, c))
    return flat[:b * ny * nx].view(b, ny, nx, c).permute(0, 3, 1, 2)


class PointPillarsScatter(nn.Module):
    """The reference's ``PointPillarsScatter`` module: pillar features (B,
    V, C) and coords (B, V, 3) [gz, gy, gx] -> the (B, ny, nx, C) canvas
    (``scatter_voxel_canvas``'s NHWC view; empty slots dropped)."""

    def __init__(self, ny: int, nx: int):
        super().__init__()
        self.ny, self.nx = ny, nx

    def forward(self, pillar_features: torch.Tensor, coords: torch.Tensor
                ) -> torch.Tensor:
        return scatter_voxel_canvas(pillar_features, coords, self.ny,
                                    self.nx).permute(0, 2, 3, 1)
