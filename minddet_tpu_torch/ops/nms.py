"""Greedy NMS and soft-NMS on the device (counterpart of the parts of
``minddet_tpu/ops/nms.py`` the ported paths use: ``_greedy_keep_from_iou``,
``nms``, ``batched_nms``, ``rotated_nms``, ``circle_nms`` and ``soft_nms``),
batched over a leading sample axis where the reference vmaps one sample at
a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minddet_tpu_torch.ops.box import pairwise_iou
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_bev


def greedy_keep_from_iou(iou: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, iou_threshold: float
                         ) -> Tuple[torch.Tensor, int]:
    """Greedy-NMS keep mask from (B, N, N) IoUs, (B, N) scores and validity.

    The reference's fixed-point iteration: a box is kept iff no earlier
    *kept* box overlaps it above the threshold, where i is earlier than j
    when its score is higher or, at equal scores, its index lower. Each
    pass is one masked (B, N, N) reduction; the loop ends when no sample's
    mask changed (a converged sample stays at its fixed point, so the
    batch gives each sample's own result) or after N passes. The test for
    a change is a host sync on a GPU. Returns (keep (B, N) bool, passes).

    Under ``torch.export`` the same fixed point is ``_fixed_point_traced``:
    a ``while_loop`` the exported program carries, whose ``passes`` is a
    0-d int64 tensor. Eager calls keep this loop: an eager ``while_loop``
    runs through ``torch.compile`` (dynamo traces ``cond`` and ``body``
    again at every new (B, N) and checks its guards at every call), which
    a served stream of varying box counts would pay on top of the same
    one host sync a pass.
    """
    suppress = _suppress(iou, scores, valid, iou_threshold)
    if torch.compiler.is_exporting():
        return _fixed_point_traced(suppress, valid)
    n = iou.shape[-1]
    keep = valid
    passes = 0
    while passes < n:
        new_keep = _pass(suppress, valid, keep)
        passes += 1
        changed = bool((new_keep != keep).any())
        keep = new_keep
        if not changed:
            break
    return keep, passes


def _suppress(iou, scores, valid, iou_threshold) -> torch.Tensor:
    """(B, N, N): i may suppress j (i earlier, both valid, IoU above the
    threshold)."""
    n = iou.shape[-1]
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    idx = torch.arange(n, device=scores.device)
    earlier = (s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :]))
    return ((iou > iou_threshold) & earlier & valid[..., :, None]
            & valid[..., None, :])


def _pass(suppress, valid, keep) -> torch.Tensor:
    return valid & ~(suppress & keep[..., :, None]).any(dim=-2)


def _fixed_point_traced(suppress, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed point as one ``while_loop`` whose carried flag and count
    stay on the device: the loop runs while some sample's mask changed and
    fewer than N passes were made."""
    from torch._higher_order_ops import while_loop

    n = suppress.shape[-1]

    def cond(keep, changed, passes):
        return changed & (passes < n)

    def body(keep, changed, passes):
        new_keep = _pass(suppress, valid, keep)
        return new_keep, (new_keep != keep).any(), passes + 1

    start = torch.ones((), dtype=torch.bool, device=valid.device)
    zero = torch.zeros((), dtype=torch.int64, device=valid.device)
    keep, _, passes = while_loop(cond, body, (valid.clone(), start, zero))
    return keep, passes


def _kept_indices(keep: torch.Tensor, scores: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """The kept boxes' indices by descending score (the lower index first
    among equal scores), -1 past the last kept one: (B, k)."""
    sel = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, idx = topk_lowest_index_first(sel, k)
    return torch.where(torch.isfinite(top), idx, torch.full_like(idx, -1))


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, score_threshold: float = float("-inf"),
        max_outputs: int | None = None
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy hard NMS over corner boxes (B, N, 4) with scores (B, N); a
    box is a candidate where its score is above ``score_threshold``.

    Returns (indices (B, K) of the kept boxes by descending score, -1
    padded, K = min(max_outputs, N); kept count (B,); the fixed point's
    passes)."""
    n = boxes.shape[-2]
    k = n if max_outputs is None else min(max_outputs, n)
    valid = scores > score_threshold
    keep, passes = greedy_keep_from_iou(pairwise_iou(boxes, boxes), scores,
                                        valid, iou_threshold)
    return (_kept_indices(keep, scores, k),
            keep.sum(dim=-1, dtype=torch.int32), passes)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float = 0.5,
                score_threshold: float = float("-inf"),
                max_outputs: int | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Class-aware ``nms``: boxes (B, N, 4) of different ``classes`` (B, N)
    never suppress each other. Each sample's boxes are shifted by class
    times that sample's own span (max - min coordinate + 1), as the
    reference does inside its per-sample ``vmap``."""
    flat = boxes.reshape(boxes.shape[0], -1)
    span = flat.amax(dim=1) - flat.amin(dim=1) + 1.0
    offsets = classes.to(boxes.dtype) * span[:, None]
    return nms(boxes + offsets[..., None], scores, iou_threshold,
               score_threshold, max_outputs)


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.1,
                score_threshold: float = float("-inf"),
                max_outputs: int | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy NMS over rotated BEV boxes (B, N, 5) [x, y, w, l, yaw] with
    scores (B, N).

    Returns (indices (B, K) of the kept boxes by descending score, -1
    padded, K = min(max_outputs, N); kept count (B,); the fixed point's
    passes). The IoU matrix is one ``rotated_iou_bev`` call over the batch:
    one K4 launch on the GPU."""
    n = boxes.shape[-2]
    k = n if max_outputs is None else min(max_outputs, n)
    valid = scores > score_threshold
    iou = rotated_iou_bev(boxes, boxes)
    keep, passes = greedy_keep_from_iou(iou, scores, valid, iou_threshold)
    return (_kept_indices(keep, scores, k),
            keep.sum(dim=-1, dtype=torch.int32), passes)


def circle_nms(centers: torch.Tensor, scores: torch.Tensor, radius: float,
               score_threshold: float = float("-inf"),
               max_outputs: int | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Centre-distance NMS (CenterPoint's ``circle_nms``) over centres (B,
    N, 2) with scores (B, N): a candidate is suppressed where its centre
    lies within ``radius`` (the squared distance below radius^2) of an
    earlier kept one. ``greedy_keep_from_iou`` on -distance^2 against
    -radius^2, as the reference does. Returns what ``rotated_nms``
    returns."""
    n = centers.shape[-2]
    k = n if max_outputs is None else min(max_outputs, n)
    valid = scores > score_threshold
    d = centers[..., :, None, :] - centers[..., None, :, :]
    keep, passes = greedy_keep_from_iou(-(d * d).sum(-1), scores, valid,
                                        -(radius * radius))
    return (_kept_indices(keep, scores, k),
            keep.sum(dim=-1, dtype=torch.int32), passes)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, sigma: float = 0.5,
             iou_threshold: float = 0.3, score_threshold: float = 0.001,
             method: str = "gaussian", top_k: int | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS (Bodla et al.): decay instead of suppress, over corner
    boxes (..., N, 4) with scores (..., N), every leading index its own set
    (the reference vmaps one set at a time).

    ``top_k`` (N where not given, at most N) passes, a fixed loop on the
    device with no host sync: each pass selects the highest current score
    (the lowest index among equal ones, as ``jnp.argmax``), writes it to
    ``new_scores`` if it is above ``score_threshold`` (else 0) and its index
    to ``order`` (else -1), decays every current score by the IoU with it
    (``method`` "gaussian": exp(-iou^2 / sigma); "linear": 1 - iou where iou
    is above ``iou_threshold``) and sets its own to -inf. Boxes never
    selected keep score 0. Returns ``(new_scores (..., N), order (...,
    k) int32)``."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"method must be 'gaussian' or 'linear', got "
                         f"{method!r}")
    n = boxes.shape[-2]
    k = n if top_k is None else min(top_k, n)
    iou = pairwise_iou(boxes, boxes)
    cur = scores.clone()
    out = torch.zeros_like(scores)
    order = torch.full(scores.shape[:-1] + (k,), -1, dtype=torch.int32,
                       device=scores.device)
    minus_inf = torch.full(scores.shape[:-1] + (1,), float("-inf"),
                           dtype=scores.dtype, device=scores.device)
    for i in range(k):
        best = torch.argmax(cur, dim=-1, keepdim=True)
        best_score = cur.gather(-1, best)
        alive = best_score > score_threshold
        out.scatter_(-1, best, torch.where(alive, best_score,
                                           torch.zeros_like(best_score)))
        order[..., i:i + 1] = torch.where(alive, best,
                                          torch.full_like(best, -1))
        ov = iou.gather(-2, best[..., None].expand(
            best.shape[:-1] + (1, n))).squeeze(-2)
        if method == "gaussian":
            decay = torch.exp(-(ov * ov) / sigma)
        else:
            decay = torch.where(ov > iou_threshold, 1.0 - ov,
                                torch.ones_like(ov))
        cur = cur * decay
        cur.scatter_(-1, best, minus_inf)
    return out, order
