"""Semantic segmentation: DeepLabV3 / V3+ (ASPP) and UNet, their loss and
mIoU (counterpart of ``minddet_tpu/models/segmentors.py``: ``ASPP``,
``DeepLabV3Plus``, ``DeepLabV3``, ``UNet`` with ``__call__`` as
``forward``, ``loss`` and ``predict``, ``segmentation_loss`` and ``miou``).

The image is NHWC (B, H, W, 3) and is cast to ``dtype``, the compute
dtype, once; inside, activations are NCHW in ``channels_last`` memory. The
logits come back NHWC (B, H, W, C) in f32 whatever ``dtype`` is: DeepLab
casts them before its final resize, as the reference does (its decoder's
resize runs in the compute dtype). Both resizes upsample, bilinearly with
half-pixel centres (``F.interpolate(align_corners=False)``, which equals
``jax.image.resize(method="bilinear")`` when upsampling). Every BN is
flax's ``BatchNorm(momentum=0.9)`` at eps 1e-5. Module names are the
reference's flax scopes, so ``utils/convert.py:load_from_flax`` carries its
variables over. No hand-written kernel runs on these paths.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.layers import (BN_EPS, BatchNorm, Conv2d,
                                             ConvTranspose2d,
                                             init_flax_defaults_,
                                             variance_scaling_)

OUTPUT_STRIDE = 16    # DeepLab's dilated ResNet
ASPP_RATES = (6, 12, 18)
ASPP_FEATURES = 256   # DeepLab's ASPP width
DECODER_LOW = 48      # the V3+ decoder's projection of C2
DECODER_WIDTH = 256   # its two 3x3 convs


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 conv (``b0``), three 3x3 convs
    dilated and padded by each of ``ASPP_RATES`` (``b1``-``b3``) and an
    image-pool branch (mean, 1x1 conv ``pool``, broadcast), none with BN or
    ReLU; their concatenation through the 1x1 ``proj``, then BN and
    ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.b0 = Conv2d(in_channels, features, 1, bias=False)
        for i, r in enumerate(ASPP_RATES):
            self.add_module(f"b{i + 1}", Conv2d(
                in_channels, features, 3, padding=r, dilation=r, bias=False))
        self.pool = Conv2d(in_channels, features, 1, bias=False)
        self.proj = Conv2d(features * (len(ASPP_RATES) + 2), features, 1,
                           bias=False)
        self.proj_bn = BatchNorm(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"b{i}")(x)
                    for i in range(len(ASPP_RATES) + 1)]
        pooled = self.pool(x.mean((2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        y = self.proj(torch.cat(branches, 1))
        return torch.relu(self.proj_bn(y))


class _Segmentor(nn.Module):
    """``loss`` and ``predict`` of the three models, over ``forward``'s
    NHWC f32 logits."""

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """image (B, H, W, 3), mask (B, H, W) class ids, valid (B, H, W)
        bool or absent -> ``segmentation_loss`` of the logits."""
        return segmentation_loss(self(batch["image"]), batch["mask"],
                                 batch.get("valid"))

    def predict(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W) int64 class ids: the argmax of the logits (BN as the
        module's mode says; the entries serve in eval mode)."""
        return self(image).argmax(-1)

    def init_weights(self, generator: torch.Generator) -> "_Segmentor":
        """The reference's initialisers, drawn from ``generator``: flax's
        defaults (LeCun-normal kernels, zero biases, identity BN), but
        He-normal for a ResNet backbone's stem and ``BasicBlock`` convs."""
        init_flax_defaults_(self, generator)
        backbone = getattr(self, "backbone", None)
        for m in [] if backbone is None else backbone.he_convs():
            variance_scaling_(m.weight, 2.0, m.weight[0].numel(), generator)
        return self


class DeepLabV3Plus(_Segmentor):
    """DeepLab v3+: the ResNet dilated to ``OUTPUT_STRIDE``, ASPP on C5
    (``ASPP_FEATURES`` wide) and, with ``use_decoder``, the decoder: the
    ASPP output resized to C2's size, concatenated with ``low_proj`` /
    ``low_bn`` / ReLU of C2 (48 channels), two 3x3 convs of 256 (``dec0``,
    ``dec1``, BN, ReLU); then the 1x1 ``out`` with a bias, cast to f32 and
    resized to the image."""

    def __init__(self, num_classes: int = 21, depth: int = 101,
                 use_decoder: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.use_decoder = use_decoder
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, output_stride=OUTPUT_STRIDE)
        c2, _, _, c5 = self.backbone.out_channels
        self.aspp = ASPP(c5, ASPP_FEATURES)
        width = ASPP_FEATURES
        if use_decoder:
            self.low_proj = Conv2d(c2, DECODER_LOW, 1, bias=False)
            self.low_bn = BatchNorm(DECODER_LOW, eps=BN_EPS)
            width += DECODER_LOW
            for i in range(2):
                self.add_module(f"dec{i}", Conv2d(width, DECODER_WIDTH, 3,
                                                  padding=1, bias=False))
                self.add_module(f"dec{i}_bn",
                                BatchNorm(DECODER_WIDTH, eps=BN_EPS))
                width = DECODER_WIDTH
        self.out = Conv2d(width, num_classes, 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) -> logits (B, H, W, num_classes) f32."""
        ih, iw = image.shape[1:3]
        c2, _, _, c5 = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        x = self.aspp(c5)
        if self.use_decoder:
            x = _resize(x, c2.shape[2:])
            low = torch.relu(self.low_bn(self.low_proj(c2)))
            x = torch.cat([x, low], 1)
            for i in range(2):
                x = getattr(self, f"dec{i}")(x)
                x = torch.relu(getattr(self, f"dec{i}_bn")(x))
        logits = self.out(x).float()
        return _resize(logits, (ih, iw)).permute(0, 2, 3, 1)


class DeepLabV3(DeepLabV3Plus):
    """Decoder-less DeepLab v3: the ASPP head straight to the logits."""

    def __init__(self, **kwargs):
        super().__init__(use_decoder=False, **kwargs)


class UNet(_Segmentor):
    """UNet: ``double_conv`` (3x3 conv without bias, BN, ReLU, twice) at
    each of ``widths[:-1]`` (``down{i}``) with a 2x2 max pool after each,
    ``widths[-1]`` at the bottom (``bottom``); then per level a 2x2
    stride-2 transposed conv with a bias (``up{i}``), its output
    concatenated before the skip, and ``double_conv`` (``dec{i}``); the 1x1
    ``out`` with a bias, cast to f32. ``up{i}`` is torch's
    ``ConvTranspose2d(2, stride 2, padding 0)``: flax's SAME at kernel =
    stride with the kernel flipped (``utils/convert.py``)."""

    def __init__(self, num_classes: int = 2,
                 widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.widths = tuple(widths)
        self.dtype = dtype
        cin = 3
        for i, c in enumerate(self.widths[:-1]):
            self._double_conv(f"down{i}", cin, c)
            cin = c
        self._double_conv("bottom", cin, self.widths[-1])
        cin = self.widths[-1]
        for i, c in enumerate(reversed(self.widths[:-1])):
            self.add_module(f"up{i}", ConvTranspose2d(cin, c, 2, stride=2))
            self._double_conv(f"dec{i}", 2 * c, c)
            cin = c
        self.out = Conv2d(cin, num_classes, 1)

    def _double_conv(self, name: str, cin: int, c: int) -> None:
        for i in range(2):
            self.add_module(f"{name}_c{i}", Conv2d(cin, c, 3, padding=1,
                                                   bias=False))
            self.add_module(f"{name}_bn{i}", BatchNorm(c, eps=BN_EPS))
            cin = c

    def _run_double_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"{name}_c{i}")(x)
            x = torch.relu(getattr(self, f"{name}_bn{i}")(x))
        return x

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) -> logits (B, H, W, num_classes) f32."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(len(self.widths) - 1):
            x = self._run_double_conv(f"down{i}", x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self._run_double_conv("bottom", x)
        for i in range(len(self.widths) - 1):
            x = torch.cat([getattr(self, f"up{i}")(x), skips[-(i + 1)]], 1)
            x = self._run_double_conv(f"dec{i}", x)
        return self.out(x).float().permute(0, 2, 3, 1)


def _one_hot(mask: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a label outside [0, num_classes) (255, -1) gives
    a row of zeros (``F.one_hot`` raises on it)."""
    classes = torch.arange(num_classes, device=mask.device)
    return (mask[..., None] == classes).to(dtype)


def segmentation_loss(logits: torch.Tensor, mask: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      dice_weight: float = 0.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pixel cross entropy over the ``valid`` pixels (all where None),
    divided by their count (at least 1), plus ``dice_weight`` times the
    soft dice loss (per image and class over the valid pixels, the
    denominator at least 1e-6, averaged). A label outside [0, C) gets no
    cross entropy but its pixel still counts where valid, as in the
    reference. Returns ``(total, {"ce": ..., ["dice": ...]})``."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits, -1)
    onehot = _one_hot(mask, num_classes, logp.dtype)
    ce = -(onehot * logp).sum(-1)
    valid = (torch.ones_like(ce) if valid is None
             else valid.to(torch.float32))
    count = valid.sum()
    ce_loss = (ce * valid).sum() / torch.maximum(count,
                                                 torch.ones_like(count))
    parts = {"ce": ce_loss}
    total = ce_loss
    if dice_weight > 0:
        p = F.softmax(logits, -1)
        v = valid[..., None]
        inter = (p * onehot * v).sum((1, 2))
        denom = ((p + onehot) * v).sum((1, 2))
        floor = torch.full_like(denom, 1e-6)
        dice = 1.0 - (2 * inter / torch.maximum(denom, floor)).mean()
        total = total + dice_weight * dice
        parts["dice"] = dice
    return total, parts


def miou(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean IoU over the classes present in ``pred`` or ``target`` (valid
    pixels only), from the confusion matrix, f32. As the reference's
    ``jnp.bincount(idx, length=(C + 1) ** 2)``, a negative index counts in
    bin 0 and one past the last bin is dropped (``torch.bincount`` would
    grow instead)."""
    if valid is None:
        valid = torch.ones_like(target, dtype=torch.bool)
    fill = torch.full_like(target, num_classes)
    p = torch.where(valid, pred, fill)
    t = torch.where(valid, target, fill)
    bins = (num_classes + 1) ** 2
    idx = (t * (num_classes + 1) + p).reshape(-1).clamp(min=0)
    cm = torch.bincount(idx[idx < bins], minlength=bins).reshape(
        num_classes + 1, num_classes + 1)[:num_classes, :num_classes]
    inter = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / union.clamp(min=1),
                      torch.zeros((), device=cm.device))
    return iou.sum() / present.sum().clamp(min=1)
