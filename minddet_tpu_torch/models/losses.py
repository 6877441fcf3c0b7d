"""Losses of the port (counterpart of ``minddet_tpu/models/losses.py``).

The CenterNet objective: ``sigmoid_clip`` for the heatmap head, the
penalty-reduced focal loss and the gathered regression loss; CenterPoint's:
the gather-based ``fast_focal_loss`` and the per-channel gathered L1. All in
f32, with explicit masks.
"""

from __future__ import annotations

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
