"""Batched image augmentation on the device (counterpart of
``minddet_tpu/data/transforms.py``: ``make_affine``, ``invert_affine``,
``sample_train_affine``, ``eval_affine``, ``warp_images`` (its points as
``affine_points``), ``transform_boxes``, ``color_aug``, ``normalize``,
``centernet_train_transform``, ``mosaic`` and ``mixup``).

The host only decodes; every geometric and photometric transform runs on
the images' device, a batch at a time. The affine warp is
``ops/bilinear.py:bilinear_warp_affine``, so on a CUDA tensor it launches
the warp kernel once per warp, which maps the pixels and reads the 3
channels as they are.

Each random transform comes in two parts: ``draw_*`` draws everything it
needs from an explicit ``torch.Generator`` on the CPU (a few values per
image), and ``*_from_draws`` takes those draws as tensors and does the
work on the images' device: the reference's function is the two run in
turn (``sample_train_affine`` is ``draw_train_affine`` then
``train_affine_from_draws``). torch cannot reproduce ``jax.random``, so the
tests hand the reference's own draws to the second part.

An "affine" is the (B, 2, 3) matrix A mapping OUTPUT pixel coordinates (x,
y, 1) to INPUT ones: the inverse warp, which sampling needs. Boxes map
with the forward matrix (``invert_affine``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# affine_points lives beside the warp kernel's plain version and is
# re-exported here, where the reference has it
from minddet_tpu_torch.ops.bilinear import (affine_points,  # noqa: F401
                                            bilinear_sample_2d,
                                            bilinear_warp_affine)

Draws = Dict[str, torch.Tensor]

# CenterNet's COCO statistics and PCA lighting basis (the reference's
# centernet/default_config.yaml and dataset.py eig_val / eig_vec)
COCO_MEAN = (0.40789654, 0.44719302, 0.47026115)
COCO_STD = (0.28863828, 0.27408164, 0.27809835)
_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
_EIG_VEC = np.array([[-0.58752847, -0.69563484, 0.41340352],
                     [-0.5832747, 0.00994535, -0.81221408],
                     [-0.56089297, 0.71832671, 0.41158938]], np.float32)
# the train affine's draws (sample_train_affine's defaults, which every
# caller of the reference keeps)
SCALE_RANGE = (0.6, 1.4)  # of the longer side
SHIFT = 0.1               # of the size, each way
FLIP_PROB = 0.5


def _uniform(generator: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    """Uniform [lo, hi) f32 on the CPU, as ``jax.random.uniform``'s
    ``minval`` / ``maxval`` give."""
    return lo + (hi - lo) * torch.rand(shape, generator=generator)


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A draw on ``ref``'s device."""
    return t.to(ref.device)


# ---------------------------------------------------------------------------
# Affine matrices
# ---------------------------------------------------------------------------

def make_affine(center: torch.Tensor, scale: torch.Tensor,
                out_hw: Tuple[int, int],
                flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 2, 3) output -> input affine f32: the input box of side
    ``scale`` (B,) centred on ``center`` (B, 2) (x, y) mapped onto the
    output, mirrored where ``flip`` (B,) bool (the reference's
    ``get_affine_transform(center, scale, 0, output_size, inv=1)``)."""
    oh, ow = out_hw
    s = scale.float() / ow  # input pixels per output pixel
    sx = torch.where(flip, -s, s) if flip is not None else s
    a = torch.zeros(center.shape[0], 2, 3, device=center.device)
    a[:, 0, 0] = sx
    a[:, 1, 1] = s
    a[:, 0, 2] = center[:, 0] - sx * (ow - 1) / 2.0
    a[:, 1, 2] = center[:, 1] - s * (oh - 1) / 2.0
    return a


def invert_affine(a: torch.Tensor) -> torch.Tensor:
    """Invert (B, 2, 3) affines."""
    m, t = a[:, :, :2], a[:, :, 2]
    det = m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]
    inv = torch.stack([torch.stack([m[:, 1, 1], -m[:, 0, 1]], -1),
                       torch.stack([-m[:, 1, 0], m[:, 0, 0]], -1)],
                      dim=1) / det[:, None, None]
    ti = -(inv[..., 0] * t[:, None, 0] + inv[..., 1] * t[:, None, 1])
    return torch.cat([inv, ti[:, :, None]], dim=-1)


def draw_train_affine(generator: torch.Generator, b: int) -> Draws:
    """The train affine's draws for ``b`` images: ``scale`` uniform in
    ``SCALE_RANGE``, ``shift_x`` and ``shift_y`` uniform in [-``SHIFT``,
    ``SHIFT``), ``flip`` bool with probability ``FLIP_PROB``."""
    return {"scale": _uniform(generator, (b,), *SCALE_RANGE),
            "shift_x": _uniform(generator, (b,), -SHIFT, SHIFT),
            "shift_y": _uniform(generator, (b,), -SHIFT, SHIFT),
            "flip": torch.rand(b, generator=generator) < FLIP_PROB}


def train_affine_from_draws(img_hw: torch.Tensor, out_hw: Tuple[int, int],
                            draws: Draws
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's train-time random affine (scale of the longer side,
    centre shifted by a share of the size, horizontal flip) from
    ``draw_train_affine``'s draws, for images of (h, w) ``img_hw`` (B, 2).
    Returns (affine (B, 2, 3), flip (B,))."""
    h = img_hw[:, 0].float()
    w = img_hw[:, 1].float()
    flip = _like(draws["flip"], img_hw)
    scale = torch.maximum(h, w) * _like(draws["scale"], img_hw)
    cx = w / 2 + w * _like(draws["shift_x"], img_hw)
    cy = h / 2 + h * _like(draws["shift_y"], img_hw)
    return make_affine(torch.stack([cx, cy], -1), scale, out_hw, flip), flip


def eval_affine(img_hw: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
    """The eval affine: the longer side fit to the output, centred."""
    h = img_hw[:, 0].float()
    w = img_hw[:, 1].float()
    return make_affine(torch.stack([w / 2, h / 2], -1), torch.maximum(h, w),
                       out_hw)


# ---------------------------------------------------------------------------
# Warping and boxes
# ---------------------------------------------------------------------------

def warp_images(images: torch.Tensor, affines: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse-affine bilinear warp of (B, H, W, C) float images ->
    (B, oh, ow, C): every output pixel's (x, y) mapped through its image's
    affine (``affine_points``) and sampled bilinearly (corners off the
    image add zero).

    The route is chosen by what is asked, never by a failure: with no
    gradient asked of the images or the affines (every caller of the
    package) it is ``bilinear_warp_affine``, on a CUDA tensor one launch of
    the warp kernel; where one is asked, ``bilinear_sample_2d`` at
    ``affine_points``, which carries the reference's gradient to the
    images and, through the weights, to the affines (on a CUDA tensor the
    row gather K3f, and K3dx / K3dcw in the backward). On the CPU both
    routes run the same plain gather."""
    images = images.contiguous()
    affines = affines.to(images.device, torch.float32).contiguous()
    if torch.is_grad_enabled() and (images.requires_grad
                                    or affines.requires_grad):
        ys, xs = affine_points(affines, out_hw)
        out = bilinear_sample_2d(images, ys, xs)
        return out.reshape(images.shape[0], *out_hw, images.shape[-1])
    return bilinear_warp_affine(images, affines, out_hw)


def transform_boxes(boxes: torch.Tensor, affines: torch.Tensor,
                    out_hw: Tuple[int, int], clip: bool = True
                    ) -> torch.Tensor:
    """(B, O, 4) xyxy input boxes -> the warped output's: the four corners
    mapped with the forward (inverted) affine, their bounding box, clipped
    to the output where ``clip``."""
    fwd = invert_affine(affines)  # input -> output
    x1, y1, x2, y2 = boxes.unbind(-1)
    corners = torch.stack([torch.stack([x1, y1], -1),
                           torch.stack([x2, y1], -1),
                           torch.stack([x1, y2], -1),
                           torch.stack([x2, y2], -1)], dim=2)  # (B,O,4,2)
    lin = fwd[:, None, None, :, :2]  # (B, 1, 1, 2, 2)
    warped = (lin[..., 0] * corners[..., None, 0]
              + lin[..., 1] * corners[..., None, 1]
              + fwd[:, None, None, :, 2])
    out = torch.cat([warped.amin(dim=2), warped.amax(dim=2)], dim=-1)
    if clip:
        oh, ow = out_hw
        out = torch.stack([out[..., 0].clamp(0, ow - 1),
                           out[..., 1].clamp(0, oh - 1),
                           out[..., 2].clamp(0, ow - 1),
                           out[..., 3].clamp(0, oh - 1)], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Photometric
# ---------------------------------------------------------------------------

def draw_color_aug(generator: torch.Generator, b: int) -> Draws:
    """``color_aug``'s draws for ``b`` images: ``brightness``,
    ``contrast`` and ``saturation`` (B, 1, 1, 1) uniform in [-0.4, 0.4),
    ``lighting`` (B, 3) standard normal."""
    return {"brightness": _uniform(generator, (b, 1, 1, 1), -0.4, 0.4),
            "contrast": _uniform(generator, (b, 1, 1, 1), -0.4, 0.4),
            "saturation": _uniform(generator, (b, 1, 1, 1), -0.4, 0.4),
            "lighting": torch.randn(b, 3, generator=generator)}


def color_aug_from_draws(images: torch.Tensor, draws: Draws
                         ) -> torch.Tensor:
    """The reference's ``color_aug``: brightness, contrast (towards the
    image's mean) and saturation (towards each pixel's gray) of 1 + the
    draw each, both means taken before any change, then the PCA lighting
    noise (0.1 x the normal draw along the eigenvalues)."""
    gs_mean = images.mean(dim=(1, 2, 3), keepdim=True)
    gray = images.mean(dim=-1, keepdim=True)
    alpha_b = 1.0 + _like(draws["brightness"], images)
    images = images * alpha_b
    alpha_c = 1.0 + _like(draws["contrast"], images)
    images = images * alpha_c + gs_mean * (1 - alpha_c)
    alpha_s = 1.0 + _like(draws["saturation"], images)
    images = images * alpha_s + gray * (1 - alpha_s)
    alpha = _like(draws["lighting"], images) * 0.1
    vec = torch.from_numpy(_EIG_VEC).to(images.device)
    val = torch.from_numpy(_EIG_VAL).to(images.device)
    lighting = (val * alpha) @ vec.T  # einsum("ij,bj->bi")
    return images + lighting[:, None, None, :]


def normalize(images: torch.Tensor, mean=COCO_MEAN, std=COCO_STD
              ) -> torch.Tensor:
    """(images - mean) / std over the last axis."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


# ---------------------------------------------------------------------------
# The CenterNet train transform
# ---------------------------------------------------------------------------

def draw_train_transform(generator: torch.Generator, b: int) -> Draws:
    """``centernet_train_transform``'s draws: {"affine":
    ``draw_train_affine``'s, "color": ``draw_color_aug``'s}."""
    return {"affine": draw_train_affine(generator, b),
            "color": draw_color_aug(generator, b)}


def centernet_train_transform_from_draws(
        images: torch.Tensor, img_hw: torch.Tensor, boxes: torch.Tensor,
        draws: Draws, out_hw: Tuple[int, int] = (512, 512)
        ) -> Dict[str, torch.Tensor]:
    """The device half of the reference's train ``preprocess_fn``: images
    (B, H, W, 3) in [0, 255] (the host's zero-padded canvas, true sizes
    ``img_hw``) scaled to [0, 1], warped by the random affine, colour
    augmented, clipped to [0, 1] and normalized; boxes (B, O, 4) xyxy
    mapped to the output. Returns image, boxes and affine."""
    images = images.float() / 255.0
    affines, _ = train_affine_from_draws(img_hw, out_hw, draws["affine"])
    warped = color_aug_from_draws(warp_images(images, affines, out_hw),
                                  draws["color"])
    return {"image": normalize(warped.clamp(0.0, 1.0)),
            "boxes": transform_boxes(boxes, affines, out_hw),
            "affine": affines}


# ---------------------------------------------------------------------------
# Mosaic and MixUp (the YOLO family's augmentations)
# ---------------------------------------------------------------------------

def draw_mosaic(generator: torch.Generator, b: int) -> Draws:
    """``mosaic``'s draws: the centre's ``cx`` and ``cy`` (B,) as shares of
    the output, uniform in [0.35, 0.65)."""
    return {"cx": _uniform(generator, (b,), 0.35, 0.65),
            "cy": _uniform(generator, (b,), 0.35, 0.65)}


def roll_batch(t: torch.Tensor, q: int) -> torch.Tensor:
    """``jnp.roll(t, -q, axis=0)`` (t itself for q = 0)."""
    return t if q == 0 else torch.roll(t, -q, dims=0)


def mosaic_from_draws(images: torch.Tensor, img_hw: torch.Tensor,
                      boxes: torch.Tensor, box_mask: torch.Tensor,
                      draws: Draws, out_hw: Tuple[int, int] = (640, 640)
                      ) -> Dict[str, torch.Tensor]:
    """4-image mosaic: sample i is images i, i+1, i+2, i+3 (mod B) in the
    four quadrants around the drawn centre, each whole image fit into its
    quadrant by one warp (four launches of the warp kernel on the card);
    boxes (B, O, 4) follow, clipped, and those under 2 px a side are
    masked out: boxes and mask (B, 4 O)."""
    oh, ow = out_hw
    cx = _like(draws["cx"], images) * ow
    cy = _like(draws["cy"], images) * oh
    b = images.shape[0]
    canvas = torch.zeros(b, oh, ow, images.shape[-1], dtype=images.dtype,
                         device=images.device)
    gy = torch.arange(oh, dtype=torch.float32,
                      device=images.device)[None, :, None]
    gx = torch.arange(ow, dtype=torch.float32,
                      device=images.device)[None, None, :]
    zero, full_w, full_h = (torch.zeros_like(cx), torch.full_like(cx, ow),
                            torch.full_like(cx, oh))
    all_boxes, all_mask = [], []
    for q in range(4):
        src_hw = roll_batch(img_hw, q)
        x0, x1 = (zero, cx) if q % 2 == 0 else (cx, full_w)
        y0, y1 = (zero, cy) if q < 2 else (cy, full_h)
        qw = (x1 - x0).clamp(min=1.0)
        qh = (y1 - y0).clamp(min=1.0)
        # output pixel -> source pixel: the whole source in the quadrant
        sx = src_hw[:, 1].float() / qw
        sy = src_hw[:, 0].float() / qh
        aff = torch.zeros(b, 2, 3, device=images.device)
        aff[:, 0, 0] = sx
        aff[:, 1, 1] = sy
        aff[:, 0, 2] = -x0 * sx
        aff[:, 1, 2] = -y0 * sy
        warped = warp_images(roll_batch(images, q), aff, out_hw)
        inside = ((gx >= x0[:, None, None]) & (gx < x1[:, None, None])
                  & (gy >= y0[:, None, None]) & (gy < y1[:, None, None]))
        canvas = torch.where(inside[..., None], warped, canvas)
        bx = roll_batch(boxes, q)
        nb = torch.stack([
            (bx[..., 0] / sx[:, None] + x0[:, None]).clamp(0, ow - 1),
            (bx[..., 1] / sy[:, None] + y0[:, None]).clamp(0, oh - 1),
            (bx[..., 2] / sx[:, None] + x0[:, None]).clamp(0, ow - 1),
            (bx[..., 3] / sy[:, None] + y0[:, None]).clamp(0, oh - 1)], -1)
        degenerate = (((nb[..., 2] - nb[..., 0]) < 2)
                      | ((nb[..., 3] - nb[..., 1]) < 2))
        all_boxes.append(nb)
        all_mask.append(roll_batch(box_mask, q) & ~degenerate)
    return {"image": canvas, "boxes": torch.cat(all_boxes, dim=1),
            "mask": torch.cat(all_mask, dim=1)}


MIXUP_ALPHA = 32.0  # mixup's Beta(alpha, alpha), the YOLO configs' default


def _standard_gamma(alpha: float, n: int, generator: torch.Generator
                    ) -> torch.Tensor:
    """n Gamma(alpha, 1) draws in f64 from ``generator``, alpha >= 1
    (Marsaglia and Tsang's squeeze)."""
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=torch.float64)
    todo = torch.arange(n)
    while len(todo):
        x = torch.randn(len(todo), generator=generator, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        u = torch.rand(len(todo), generator=generator, dtype=torch.float64)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    return out


def draw_mixup(generator: torch.Generator, b: int) -> Draws:
    """``mixup``'s draw: ``lam`` (B, 1, 1, 1) f32 from Beta(``MIXUP_ALPHA``,
    ``MIXUP_ALPHA``) (two Gamma draws, g1 / (g1 + g2))."""
    g1 = _standard_gamma(MIXUP_ALPHA, b, generator)
    g2 = _standard_gamma(MIXUP_ALPHA, b, generator)
    return {"lam": (g1 / (g1 + g2)).float().reshape(b, 1, 1, 1)}


def mixup_from_draws(images: torch.Tensor, boxes: torch.Tensor,
                     box_mask: torch.Tensor, draws: Draws
                     ) -> Dict[str, torch.Tensor]:
    """Each image blended with the next (mod B) at ``lam`` : 1 - ``lam``;
    boxes and mask are the two images' together (B, 2 O)."""
    lam = _like(draws["lam"], images)
    return {"image": images * lam + roll_batch(images, 1) * (1 - lam),
            "boxes": torch.cat([boxes, roll_batch(boxes, 1)], dim=1),
            "mask": torch.cat([box_mask, roll_batch(box_mask, 1)], dim=1)}
