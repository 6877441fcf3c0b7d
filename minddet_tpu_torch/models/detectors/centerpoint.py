"""CenterPoint serving from raw points, one- and two-stage (counterpart of
the stream predict paths of ``minddet_tpu/models/detectors/centerpoint.py``:
``_bev_from_points_stream``, ``predict_from_points`` and
``CenterPointTwoStage.predict_refined``).

    points (B, N, 5) + mask -> stream voxelize -> two-layer stream PFN (the
    non-last layer broadcasts each pillar's max back: the segment-max
    kernel) -> one canvas scatter -> SECOND RPN (up strides 0.5, 1, 2) ->
    BEV map (B, 384, ny/4, nx/4) -> CenterHead (six tasks) -> per task the
    top ``nms_pre`` peaks decoded to world boxes -> rotated NMS (one launch
    of the intersection kernel for all tasks) -> (B, T * nms_post) boxes
    [x, y, z, w, l, h, vx, vy, yaw]

    two-stage: -> 5 bilinear samples of the BEV map per detection (the
    row-gather kernel) -> MLP -> score = sqrt(stage-1 score * sigmoid(
    quality logit)), box refined by the SECOND residual

The canvas is built as PointPillars builds it (``ops/voxelize.py:
scatter_stream_canvas``); the reference's three canvas builders (compact,
sorted-add, ``.set``), its 65th scatter channel and ``rpn_space_to_depth``
are TPU layouts of the same canvas.

Eval only; the configuration's fields are the reference's, with its
defaults (the nuScenes model of ``configs/centerpoint_pp_nusc.yaml`` and
``centerpoint_pp_nusc_two_stage.yaml``). Not ported: the padded-voxel
``__call__`` / ``predict``, double-flip TTA, the losses.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.heads.center_head import (CenterHead, Preds,
                                                        SepHead)
from minddet_tpu_torch.models.heads.second_stage import (BEVFeatureExtractor,
                                                         BEVRefineHead)
from minddet_tpu_torch.models.layers import init_flax_defaults_
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.models.readers.pillar_encoder import PillarFeatureNet
from minddet_tpu_torch.ops.box import second_box_decode
from minddet_tpu_torch.ops.voxelize import (scatter_stream_canvas,
                                            voxelize_stream_batch)

_BOX7 = [0, 1, 2, 3, 4, 5, 8]  # [x, y, z, w, l, h, yaw] of a 9-wide box


class CenterPoint(nn.Module):
    def __init__(
        self,
        task_num_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
        grid_ny: int = 512,
        grid_nx: int = 512,
        voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0),
        pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        num_point_features: int = 5,
        pfn_filters: Sequence[int] = (64, 64),
        rpn_layer_nums: Sequence[int] = (3, 5, 5),
        rpn_strides: Sequence[int] = (2, 2, 2),
        rpn_filters: Sequence[int] = (64, 128, 256),
        rpn_up_strides: Sequence[float] = (0.5, 1, 2),
        rpn_up_filters: Sequence[int] = (128, 128, 128),
        out_size_factor: int = 4,
        max_voxels: int = 30000,
        max_points_per_voxel: int = 20,
        voxel_drop_order: str = "sorted",
    ):
        super().__init__()
        self.task_num_classes = tuple(task_num_classes)
        self.grid_ny, self.grid_nx = grid_ny, grid_nx
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.out_size_factor = out_size_factor
        self.max_voxels = max_voxels
        self.max_points_per_voxel = max_points_per_voxel
        self.voxel_drop_order = voxel_drop_order

        # the decorated stream: the point, its offsets from the pillar's
        # mean (3) and from the pillar's centre (2)
        self.reader = PillarFeatureNet(num_point_features + 5, pfn_filters)
        self.rpn = SECONDRPN(pfn_filters[-1], rpn_layer_nums, rpn_strides,
                             rpn_filters, rpn_up_strides, rpn_up_filters)
        self.head = CenterHead(self.rpn.out_channels, task_num_classes)

    def pillars_from_points(self, points: torch.Tensor,
                            points_mask: torch.Tensor):
        """Points (B, N, F) + mask (B, N) -> (stream voxels, the stream
        PFN's output (B, N, C): each pillar's feature at its last kept
        row)."""
        sv = voxelize_stream_batch(
            points, points_mask, self.voxel_size, self.pc_range,
            self.max_voxels, self.max_points_per_voxel,
            self.voxel_drop_order)
        h = self.reader.stream(sv.feats, sv.keep, sv.first, sv.last,
                               bound=self.max_points_per_voxel)
        return sv, h

    def bev_from_points_stream(self, points: torch.Tensor,
                               points_mask: torch.Tensor) -> torch.Tensor:
        """Points -> the neck's BEV feature map (B, C, ny/4, nx/4) in
        ``channels_last`` memory (the second stage samples its NHWC view in
        place; the conversion is a no-op where the RPN's convolutions kept
        that layout)."""
        sv, h = self.pillars_from_points(points, points_mask)
        canvas, _ = scatter_stream_canvas(h, sv, self.grid_ny, self.grid_nx)
        return self.rpn(canvas).contiguous(memory_format=torch.channels_last)

    def forward(self, points: torch.Tensor,
                points_mask: torch.Tensor) -> Preds:
        """Points -> per task the six prediction maps (B, H, W, C)."""
        return self.head(self.bev_from_points_stream(points, points_mask))

    def _head_predict(self, preds: Preds, score_threshold, nms_pre, nms_post,
                      nms_iou) -> Dict:
        return self.head.predict(
            preds, pc_range=self.pc_range, voxel_size=self.voxel_size,
            out_size_factor=self.out_size_factor,
            score_threshold=score_threshold, nms_pre=nms_pre,
            nms_post=nms_post, nms_iou=nms_iou)

    @torch.inference_mode()
    def predict_from_points(self, points: torch.Tensor,
                            points_mask: torch.Tensor,
                            score_threshold: float = 0.1,
                            nms_pre: int = 1000, nms_post: int = 83,
                            nms_iou: float = 0.2) -> Dict:
        """Raw padded points (B, N, F) + mask (B, N) -> detections: boxes
        (B, T * nms_post, 9), scores, labels int32 (dropped slots 0, 0,
        -1), ``nms_passes``."""
        return self._head_predict(self(points, points_mask), score_threshold,
                                  nms_pre, nms_post, nms_iou)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CenterPoint":
        """flax's default initialisers drawn from ``generator``
        (``init_flax_defaults_``), and the heatmap branches' final bias at
        the head's ``init_bias`` (-2.19), as the reference starts them."""
        init_flax_defaults_(self, generator)
        for m in self.modules():
            if isinstance(m, SepHead):
                m.hm_out.bias.fill_(m.init_bias)
        return self


class CenterPointTwoStage(CenterPoint):
    """CenterPoint plus the BEV-feature second stage: ``extractor`` (no
    parameters) and ``refine`` on top of the single-stage modules."""

    def __init__(self, *args, refine_hidden: int = 128, **kwargs):
        super().__init__(*args, **kwargs)
        self.extractor = BEVFeatureExtractor(self.pc_range, self.voxel_size,
                                             self.out_size_factor)
        self.refine = BEVRefineHead(5 * self.rpn.out_channels, refine_hidden)

    def refine_detections(self, bev: torch.Tensor, det: Dict,
                          refine_boxes: bool = True) -> Dict:
        """Stage-1 detections + the BEV map -> rescored (sqrt(stage-1 score
        * sigmoid(quality logit))) and, with ``refine_boxes``, refined by
        the decoded SECOND residual. Dropped slots (label -1, zero boxes)
        are sampled like the others and masked afterwards, as in the
        reference."""
        slog, deltas = self.refine(self.extractor(bev, det["boxes"]))
        valid = det["labels"] >= 0
        scores = torch.where(
            valid, torch.sqrt((det["scores"] * torch.sigmoid(slog)).clamp(
                min=0.0)), 0.0)
        boxes = det["boxes"].float()
        if refine_boxes:
            dec = second_box_decode(deltas, boxes[..., _BOX7])
            boxes = torch.cat([dec[..., :6], boxes[..., 6:8], dec[..., 6:]],
                              dim=-1)
            boxes = torch.where(valid[..., None], boxes, 0.0)
        return {"boxes": boxes, "scores": scores, "labels": det["labels"],
                "nms_passes": det["nms_passes"]}

    @torch.inference_mode()
    def predict_refined(self, points: torch.Tensor,
                        points_mask: torch.Tensor,
                        score_threshold: float = 0.1, nms_pre: int = 1000,
                        nms_post: int = 83, nms_iou: float = 0.2,
                        refine_boxes: bool = True) -> Dict:
        """Raw points -> stage-1 detections -> stage-2 rescore and refine:
        boxes (B, T * nms_post, 9), scores, labels, ``nms_passes``."""
        bev = self.bev_from_points_stream(points, points_mask)
        det = self._head_predict(self.head(bev), score_threshold, nms_pre,
                                 nms_post, nms_iou)
        return self.refine_detections(bev, det, refine_boxes)
