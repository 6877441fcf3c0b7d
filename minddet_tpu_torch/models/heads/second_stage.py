"""CenterPoint's second stage, in eval (counterpart of
``minddet_tpu/models/heads/second_stage.py``): each box samples the BEV
feature map bilinearly at 5 points (its centre and the midpoints of its four
BEV sides), through ``ops/bilinear.py:bilinear_sample_2d``; an MLP over the
concatenated samples gives a class-agnostic quality logit and a SECOND
residual refining [x, y, z, w, l, h, yaw].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.readers.pillar_encoder import MaskedBatchNorm
from minddet_tpu_torch.ops.bilinear import bilinear_sample_2d
from minddet_tpu_torch.ops.box import center_to_corner_box2d

BN_EPS = 1e-3  # with flax momentum 0.99, which eval never reads


def bev_sample_points(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, >= 9) boxes [x, y, z, w, l, h, vx, vy, yaw] -> (..., N, 5,
    2) world xy sample points: the centre and the 4 side midpoints of the
    BEV rectangle."""
    centers = boxes[..., :2]
    corners = center_to_corner_box2d(centers, boxes[..., 3:5], boxes[..., -1])
    faces = 0.5 * (corners + torch.roll(corners, -1, dims=-2))
    return torch.cat([centers[..., None, :], faces], dim=-2)


class BEVFeatureExtractor(nn.Module):
    """Sample the RPN's BEV map at 5 points per box: ``bev`` (B, C, H, W)
    in ``channels_last`` memory, ``boxes`` (B, N, >= 9) in the world ->
    (B, N, 5 * C). The world -> map transform inverts the head's decode
    (x = (col + reg) * out_size_factor * voxel + range_min; H is the y
    axis), so a box's centre samples the cell its peak came from. No
    parameters."""

    def __init__(self, pc_range: Sequence[float],
                 voxel_size: Sequence[float], out_size_factor: int = 4):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.out_size_factor = out_size_factor

    def forward(self, bev: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        b, c = bev.shape[:2]
        n = boxes.shape[1]
        pts = bev_sample_points(boxes)
        fx = (pts[..., 0] - self.pc_range[0]) / (
            self.voxel_size[0] * self.out_size_factor)
        fy = (pts[..., 1] - self.pc_range[1]) / (
            self.voxel_size[1] * self.out_size_factor)
        feats = bilinear_sample_2d(bev.permute(0, 2, 3, 1),
                                   fy.reshape(b, n * 5), fx.reshape(b, n * 5))
        return feats.reshape(b, n, 5 * c)


class BEVRefineHead(nn.Module):
    """Two Linear (no bias) + BN + ReLU blocks named ``fc{i}`` / ``bn{i}``,
    then the ``score`` (1) and ``box`` (``code_size``) Linear heads:
    (B, N, F) -> (score logits (B, N), box deltas (B, N, code_size)), f32.
    In eval BN over the feature axis is the folded affine that
    ``MaskedBatchNorm`` computes."""

    def __init__(self, in_features: int, hidden: int = 128,
                 code_size: int = 7):
        super().__init__()
        cin = in_features
        for i in range(2):
            self.add_module(f"fc{i}", nn.Linear(cin, hidden, bias=False))
            self.add_module(f"bn{i}", MaskedBatchNorm(hidden, eps=BN_EPS))
            cin = hidden
        self.score = nn.Linear(hidden, 1)
        self.box = nn.Linear(hidden, code_size)

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = feats.to(self.fc0.weight.dtype)
        for i in range(2):
            x = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"fc{i}")(x)))
        return self.score(x)[..., 0].float(), self.box(x).float()
