"""ROIAlign through the row gather (counterpart of
``minddet_tpu/ops/roi_align.py``).

Each roi's bins are sampled on an s x s grid of points, and all the points
of all rois of one map are one ``bilinear_sample_2d`` call: on the GPU one
launch of the row-gather kernel (``csrc/bilinear_gather.cu``, K3f) per map.
Boxes are [x1, y1, x2, y2]; the torchvision ``aligned=False`` convention;
a roi narrower or lower than 1 is sampled as 1 wide or high.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from minddet_tpu_torch.ops.bilinear import bilinear_sample_2d


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded once, as a fused multiply-add
    rounds it (the product of two f32 values is exact in f64): the sample
    coordinates then do not depend on whether a compiler contracts the
    expression, as XLA's CPU compile of the reference does."""
    return (a.double() * b.double() + c.double()).float()


def roi_sample_points(boxes: torch.Tensor, output_size: Tuple[int, int],
                      sampling_ratio: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sample points of (B, R, 4) boxes, (ys, xs), each (B, R * ph * s
    * pw * s): roi by roi, row of samples by row, an s x s grid in each
    bin."""
    b, r = boxes.shape[:2]
    ph, pw = output_size
    s = sampling_ratio
    x1, y1, x2, y2 = boxes.unbind(-1)
    rw = (x2 - x1).clamp(min=1.0)[..., None]  # (B, R, 1)
    rh = (y2 - y1).clamp(min=1.0)[..., None]
    # the reference's compiled form: XLA turns the division by a constant
    # into a product with its f32 reciprocal
    bin_w = rw * (1.0 / pw)
    bin_h = rh * (1.0 / ph)
    dev = boxes.device
    gy = (torch.arange(ph * s, dtype=torch.float32, device=dev) + 0.5) / s
    gx = (torch.arange(pw * s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = _fma(bin_h, gy, y1[..., None])  # (B, R, ph * s)
    xs = _fma(bin_w, gx, x1[..., None])  # (B, R, pw * s)
    return (ys[..., :, None].expand(b, r, ph * s, pw * s).reshape(b, -1),
            xs[..., None, :].expand(b, r, ph * s, pw * s).reshape(b, -1))


def _bins(features: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
          r: int, output_size: Tuple[int, int],
          sampling_ratio: int) -> torch.Tensor:
    """The features sampled at ``roi_sample_points`` of r rois, each bin
    the mean of its s x s samples -> (B, R, ph, pw, C)."""
    b, c = features.shape[0], features.shape[-1]
    ph, pw = output_size
    s = sampling_ratio
    samples = bilinear_sample_2d(features, ys, xs)
    return samples.view(b, r, ph, s, pw, s, c).mean(dim=(3, 5))


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: Tuple[int, int] = (7, 7),
              sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C), contiguous (the NHWC view of a
    ``channels_last`` map), and boxes (B, R, 4) in the map's coordinates ->
    (B, R, ph, pw, C) in the features' type: each bin the mean of its s x s
    samples."""
    ys, xs = roi_sample_points(boxes, output_size, sampling_ratio)
    return _bins(features, ys, xs, boxes.shape[1], output_size,
                 sampling_ratio)


def roi_levels(boxes: torch.Tensor, num_levels: int,
               canonical_scale: float = 224.0, canonical_level: int = 2
               ) -> torch.Tensor:
    """The FPN level (B, R) int64 of each roi of (B, R, 4) image-coordinate
    boxes: floor(k0 + log2(sqrt(area) / 224 + 1e-8)) (FPN paper, eq. 1),
    clipped into [0, num_levels)."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    k = torch.floor(canonical_level
                    + torch.log2(torch.sqrt(area) / canonical_scale + 1e-8))
    return k.clamp(0, num_levels - 1).long()


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, strides: Sequence[int],
                         output_size: Tuple[int, int] = (7, 7),
                         canonical_scale: float = 224.0,
                         canonical_level: int = 2, sampling_ratio: int = 2
                         ) -> torch.Tensor:
    """FPN ROIAlign: features a list of (B, Hi, Wi, C) maps (NHWC views of
    ``channels_last`` maps) at ``strides``, boxes (B, R, 4) in image
    coordinates -> (B, R, ph, pw, C) in f32 (f64 for f64 maps).

    As the reference does, every level samples every roi, and each roi
    takes its own level's result through an f32 one-hot select: one
    ``roi_align`` (one gather) per level, whatever the rois' sizes. The
    select adds 1 x its level's value and 0 x every other level's, in
    level order, so it returns the selected value exactly and carries a
    NaN or inf of any level, as the reference's ``einsum`` does."""
    k = roi_levels(boxes, len(features), canonical_scale, canonical_level)
    n, (b, r) = len(features), boxes.shape[:2]
    # every level's boxes and sample points at once, as each level's
    # ``roi_align`` would compute them: the same division and rounding
    div = torch.tensor(list(strides), dtype=boxes.dtype,
                       device=boxes.device)[:, None, None, None]
    ys, xs = roi_sample_points((boxes / div).reshape(n * b, r, 4),
                               output_size, sampling_ratio)
    ys, xs = ys.view(n, b, -1), xs.view(n, b, -1)
    out = None
    for li, feat in enumerate(features):
        level = _bins(feat, ys[li], xs[li], r, output_size, sampling_ratio)
        acc = torch.promote_types(level.dtype, torch.float32)
        sel = (k == li).to(acc)[..., None, None, None]
        term = sel * level.to(acc)
        out = term if out is None else out + term
    return out
