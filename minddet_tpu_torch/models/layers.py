"""Shared building blocks (counterpart of ``minddet_tpu/models/layers.py``).

Modules take and return NCHW tensors kept in ``torch.channels_last`` memory,
so the NHWC view the DCN sampler reads (``x.permute(0, 2, 3, 1)``) is
already contiguous and costs no copy.

Compute dtype: as in flax (``dtype=bf16`` over f32 params), the convs and
the DCN contraction run in their input's dtype, casting their weights to it
(a no-op when the weights already have it, as in the serving model), and
BatchNorm normalises in f32 and returns its input's dtype. ``CenterNet``
casts the image to its ``dtype`` once; everything downstream follows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.ops.dcn import deform_conv2d

BN_EPS = 1e-5


def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``, in
    place: scale 1 is flax's default ``lecun_normal``, 2 ``he_normal``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_flax_defaults_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers over every submodule, in place, drawn
    from ``generator``: LeCun-normal kernels (Linear, Conv2d,
    ConvTranspose2d), zero biases, identity BN (scale 1, bias 0, mean 0,
    var 1) for every module with running statistics."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            variance_scaling_(m.weight, 1.0, m.in_features, generator)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # Conv2d weight (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw):
            # fan_in = I*kh*kw either way
            i = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
            variance_scaling_(m.weight, 1.0, i * m.weight[0, 0].numel(),
                              generator)
        elif hasattr(m, "running_var"):
            nn.init.ones_(m.weight)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (weight and bias cast to
    it, as flax's ``Conv(dtype=...)`` does)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (flax's
    ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax's ``BatchNorm(momentum=0.9)`` semantics.

    Train mode normalises with the batch's mean and *biased* variance,
    computed in f32 (f64 for an f64 input) whatever the input's dtype, and
    updates the running statistics in place as flax does: ``ra = 0.9 * ra
    + 0.1 * stat``, with the biased variance stored (``nn.BatchNorm2d``
    stores the unbiased one). ``momentum`` keeps torch's meaning, the
    weight of the new statistic (0.1 here is flax's 0.9). Eval mode is
    ``nn.BatchNorm2d``'s.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        stat = torch.promote_types(x.dtype, torch.float32)
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight.to(stat), self.bias.to(stat), None, None, True,
            0.0, self.eps)
        with torch.no_grad():
            # native_batch_norm returns invstd = (var + eps) ** -0.5
            var = invstd.pow(-2) - self.eps
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
        return out


class ModulatedDeformConv(nn.Module):
    """DCNv2 layer: offset/mask conv + deformable sampling conv.

    ``conv_offset`` emits 3K channels (K = kernel_size**2) with the layer's
    kernel size, stride and padding, zero-initialised as in the reference,
    so a new layer is a plain conv with 0.5 modulation: [0, 2K) reshape to
    (K, 2) as (dy, dx), [2K, 3K) are the mask logits (the reference's
    layout, not mmcv's). ``kernel`` keeps the reference's (kh, kw, Cin,
    Cout) layout, which the contraction reshapes to (K*Cin, Cout); ``bias``
    (Cout,) exists with ``use_bias``, zero at first. The defaults (3x3,
    stride 1, padding 1, no bias) are the CenterNet path's.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 use_bias: bool = False):
        super().__init__()
        k = kernel_size * kernel_size
        self.stride = stride
        self.padding = padding
        self.conv_offset = Conv2d(in_channels, 3 * k, kernel_size,
                                  stride=stride, padding=padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size,
                                               in_channels, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0] * self.kernel.shape[1]
        off_mask = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 3K)
        b, ho, wo, _ = off_mask.shape
        offsets = off_mask[..., :2 * k].reshape(b, ho, wo, k, 2)
        mask = torch.sigmoid(off_mask[..., 2 * k:])
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, mask,
                          self.kernel.to(x.dtype), _cast(self.bias, x.dtype),
                          stride=self.stride, padding=self.padding)
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
        self.bn1 = BatchNorm(features, eps=BN_EPS)
        self.up = ConvTranspose2d(features, features, 4, stride=2, padding=1)
        self.bn2 = BatchNorm(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.dcn(x)))
        return torch.relu(self.bn2(self.up(x)))
