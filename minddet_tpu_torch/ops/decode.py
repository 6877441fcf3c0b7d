"""CenterNet heatmap decode, NHWC, on the device; counterpart of
``minddet_tpu/ops/decode.py``.

Top-k keeps JAX's tie order (``jax.lax.top_k`` puts the lower index first
among equal values): after peak-NMS most of a sparse heatmap is exact zeros,
so the tie order decides which indices and classes come out. A stable
descending sort reproduces it; ``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def topk_lowest_index_first(v: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: among equal values the lower index
    comes first (a stable descending sort; ``torch.topk`` promises no order
    among ties)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def heatmap_peaks(heat: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima of (B, H, W, C) heatmaps (3x3 maxpool-as-NMS,
    -inf padding)."""
    nchw = heat.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(nchw, 3, stride=1, padding=1)
    hmax = hmax.permute(0, 2, 3, 1)
    return torch.where(heat == hmax, heat, torch.zeros_like(heat))


def topk_heatmap(heat: torch.Tensor, k: int = 100):
    """Two-stage top-k over (B, H, W, C): per class, then global.

    Returns (scores, inds, classes, ys, xs), each (B, K); ``inds`` indexes
    the flattened H*W plane.
    """
    b, h, w, c = heat.shape
    per_class = heat.permute(0, 3, 1, 2).reshape(b, c, h * w)
    scores1, inds1 = topk_lowest_index_first(per_class, k)  # (B, C, K)
    ys1 = torch.div(inds1, w, rounding_mode="floor").float()
    xs1 = (inds1 % w).float()

    scores2, inds2 = topk_lowest_index_first(scores1.reshape(b, c * k), k)
    classes = torch.div(inds2, k, rounding_mode="floor").to(torch.int32)
    inds = torch.gather(inds1.reshape(b, c * k), 1, inds2)
    ys = torch.gather(ys1.reshape(b, c * k), 1, inds2)
    xs = torch.gather(xs1.reshape(b, c * k), 1, inds2)
    return scores2, inds, classes, ys, xs


def gather_feature(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Gather (B, H, W, C) features at flat H*W indices (B, K) -> (B, K, C)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, inds[..., None].expand(-1, -1, c))


def centernet_decode(outputs: Dict[str, torch.Tensor],
                     k: int = 100) -> torch.Tensor:
    """Heads -> (B, K, 6) [x1, y1, x2, y2, score, class] in output-stride
    units. ``outputs`` holds NHWC 'hm' (sigmoid-clipped), 'wh' and
    optionally 'reg'."""
    heat = heatmap_peaks(outputs["hm"])
    scores, inds, classes, ys, xs = topk_heatmap(heat, k)

    wh = gather_feature(outputs["wh"], inds)
    if outputs.get("reg") is not None:
        reg = gather_feature(outputs["reg"], inds)
        xs = xs + reg[..., 0]
        ys = ys + reg[..., 1]
    else:
        xs = xs + 0.5
        ys = ys + 0.5

    ws, hs = wh[..., 0], wh[..., 1]
    bboxes = torch.stack(
        [xs - ws / 2, ys - hs / 2, xs + ws / 2, ys + hs / 2], dim=-1)
    return torch.cat(
        [bboxes, scores[..., None], classes.to(bboxes.dtype)[..., None]],
        dim=-1)
