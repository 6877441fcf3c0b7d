"""Losses of the port (counterpart of ``minddet_tpu/models/losses.py``).

The CenterNet objective: ``sigmoid_clip`` for the heatmap head, the
penalty-reduced focal loss and the gathered regression loss; CenterPoint's:
the gather-based ``fast_focal_loss`` and the per-channel gathered L1;
PointPillars': the sigmoid focal loss, SECOND's smooth L1 and the weighted
softmax cross entropy of the direction classifier. All with explicit masks;
the last three return per-element losses for the caller to reduce.
"""

from __future__ import annotations

from typing import Optional

import torch

from minddet_tpu_torch.ops.decode import gather_feature


def sigmoid_clip(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1 - eps] so log() is safe."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def centernet_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                         alpha: float = 2.0, beta: float = 4.0
                         ) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss on an already-sigmoided heatmap.

    Positives are pixels where target == 1; all others are negatives
    weighted by (1 - target)^beta. Normalised by the positive count (at
    least 1).
    """
    target = target.float()
    pos = (target == 1.0).float()
    neg = (target < 1.0).float()
    neg_weights = torch.pow(1.0 - target, beta)
    pred = pred.float()
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, alpha) * neg_weights
                * neg)
    num_pos = torch.clamp(pos.sum(), min=1.0)
    return -(pos_loss.sum() + neg_loss.sum()) / num_pos


def gather_reg_loss(output: torch.Tensor, mask: torch.Tensor,
                    ind: torch.Tensor, target: torch.Tensor,
                    mode: str = "l1") -> torch.Tensor:
    """Masked regression loss at gathered object centres.

    output (B, H, W, C) dense head; ind (B, O) flat H*W indices; mask (B, O)
    validity; target (B, O, C). The sum of the L1 (or smooth-L1) terms over
    2 * sum(mask) + 1e-4, the reference's "num = sum(mask) * 2" included.
    """
    if mode not in ("l1", "sl1"):
        raise ValueError(f"mode must be l1/sl1, got {mode}")
    pred = gather_feature(output, ind).float()  # (B, O, C)
    mask = mask.float()
    num = mask.sum() * 2.0
    diff = (pred - target.float()) * mask[..., None]
    absd = torch.abs(diff)
    if mode == "l1":
        loss = absd.sum()
    else:
        loss = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5).sum()
    return loss / (num + 1e-4)


def fast_focal_loss(pred_hm: torch.Tensor, target_hm: torch.Tensor,
                    ind: torch.Tensor, mask: torch.Tensor,
                    cat: torch.Tensor) -> torch.Tensor:
    """CenterPoint's gather-based focal loss on an already-sigmoided
    heatmap: the negative term over every pixel, weighted (1 - target)^4,
    the positive term only at the object centres. pred_hm, target_hm (B, H,
    W, C); ind (B, O) flat H*W positions; mask (B, O); cat (B, O) class
    ids. Normalised by the positive count (at least 1)."""
    pred_hm = pred_hm.float()
    neg_loss = (torch.log(1.0 - pred_hm) * torch.pow(pred_hm, 2.0)
                * torch.pow(1.0 - target_hm.float(), 4.0)).sum()
    pos_pred = torch.gather(gather_feature(pred_hm, ind), 2,
                            cat.long()[..., None])[..., 0]
    m = mask.float()
    pos_loss = (torch.log(pos_pred) * torch.pow(1.0 - pos_pred, 2.0)
                * m).sum()
    return -(pos_loss + neg_loss) / torch.clamp(m.sum(), min=1.0)


def gather_reg_loss_per_channel(output: torch.Tensor, mask: torch.Tensor,
                                ind: torch.Tensor, target: torch.Tensor
                                ) -> torch.Tensor:
    """Per-channel masked L1 at the gathered centres -> (C,): summed over
    batch and objects, over sum(mask) + 1e-4, so that the caller can weight
    the channels. output (B, H, W, C); target (B, O, C)."""
    pred = gather_feature(output, ind).float()  # (B, O, C)
    m = mask.float()[..., None]
    return (torch.abs(pred - target.float()) * m).sum(dim=(0, 1)) / (
        m.sum() + 1e-4)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise ``max(x, 0) - x t + log1p(exp(-|x|))`` as the reference
    writes it by hand (``yolox.py:_bce``, the R-CNN's RPN and mask losses),
    with JAX's gradients at x = 0: ``maximum`` passes half of it, and
    ``|x|`` has slope 1 there (torch's ``abs`` has 0), so the gradient at 0
    is -t, as in the reference."""
    neg_abs = torch.where(logits >= 0, -logits, logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * target
            + torch.log1p(torch.exp(neg_abs)))


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Numerically stable sigmoid cross entropy, written as optax's
    ``sigmoid_binary_cross_entropy``: relu(x) - x * z + log1p(exp(-|x|))."""
    zeros = torch.zeros_like(logits)
    cond = logits >= zeros
    relu_logits = torch.where(cond, logits, zeros)
    neg_abs = torch.where(cond, -logits, logits)
    return relu_logits - logits * labels + torch.log1p(torch.exp(neg_abs))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Per-entry sigmoid focal loss (RetinaNet form) against one-hot
    ``targets`` (..., C): (1 - p_t)^gamma times the alpha weight times the
    sigmoid cross entropy; ``weights`` multiply per anchor (one dim fewer
    than the loss) or per entry."""
    per_entry = optax_sigmoid_ce(logits, targets)
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1 - targets) * (1 - prob)
    modulator = torch.pow(1.0 - p_t, gamma)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    loss = modulator * alpha_w * per_entry
    if weights is not None:
        loss = loss * (weights[..., None] if weights.dim() == loss.dim() - 1
                       else weights)
    return loss


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       sigma: float = 3.0) -> torch.Tensor:
    """SECOND's smooth L1 per code (..., C), in f32: 0.5 sigma^2 d^2 below
    |d| = 1 / sigma^2, |d| - 0.5 / sigma^2 above; ``weights`` (...,) scale
    each anchor's row."""
    diff = pred.float() - target.float()
    abs_diff = diff.abs()
    s2 = sigma * sigma
    loss = torch.where(abs_diff < 1.0 / s2, 0.5 * s2 * diff * diff,
                       abs_diff - 0.5 / s2)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_softmax_ce(logits: torch.Tensor, targets: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Softmax cross entropy against one-hot ``targets`` (..., C), the
    logits in f32, times per-anchor ``weights`` (...,): (...,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -(targets * logp).sum(-1)
    if weights is not None:
        loss = loss * weights
    return loss
