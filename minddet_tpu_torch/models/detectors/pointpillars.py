"""PointPillars serving from raw points (counterpart of the predict path of
``minddet_tpu/models/detectors/pointpillars.py``: ``predict_from_points``
with the stream voxelizer, ``_canvas_from_points``, the heads of
``_preds_from_canvas`` and ``_predict_from_preds``).

    points (B, N, 4) + mask -> stream voxelize -> stream PFN -> one canvas
    scatter (+ occupancy) -> SECOND RPN -> 1x1 cls/box/dir heads -> sigmoid,
    anchor-area mask, top-``nms_pre`` -> SECOND decode + direction flip ->
    rotated NMS (one K4 launch for the batch) -> (B, nms_post) boxes

The canvas is one (B, 64, ny, nx) map in ``channels_last`` memory, built by
one ``index_copy_`` of each pillar's last kept stream row (where the
running max holds the whole pillar's max) into B * ny * nx + 1 rows, the
last row taking the dropped ones; the occupancy map comes from the same
indices. The reference's TPU layouts (space-to-depth scatter, the 65th
occupancy channel, the compact scatter) compute the same canvas.

Eval only; the configuration's fields are the reference's, with its
defaults (the KITTI car model of ``configs/pointpillars_car_kitti.yaml``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.layers import Conv2d, variance_scaling_
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.models.readers.pillar_encoder import (
    MaskedBatchNorm, PillarFeatureNet)
from minddet_tpu_torch.ops.anchors import (ClassAnchorConfig,
                                           generate_anchors,
                                           make_grid_area_mask)
from minddet_tpu_torch.ops.box import limit_period, second_box_decode
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import rotated_nms
from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch

Preds = Dict[str, torch.Tensor]


class PointPillars(nn.Module):
    def __init__(
        self,
        num_classes: int = 1,
        grid_ny: int = 496,
        grid_nx: int = 432,
        voxel_size: Tuple[float, float, float] = (0.16, 0.16, 4.0),
        pc_range: Tuple[float, ...] = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
        pfn_filters: Sequence[int] = (64,),
        rpn_layer_nums: Sequence[int] = (3, 5, 5),
        rpn_strides: Sequence[int] = (2, 2, 2),
        rpn_filters: Sequence[int] = (64, 128, 256),
        rpn_up_strides: Sequence[int] = (1, 2, 4),
        rpn_up_filters: Sequence[int] = (128, 128, 128),
        num_anchor_per_loc: int = 2,
        box_code_size: int = 7,
        use_direction_classifier: bool = True,
        anchor_sizes: Sequence[Tuple[float, ...]] = ((1.6, 3.9, 1.56),),
        anchor_strides: Sequence[Tuple[float, ...]] = ((0.32, 0.32, 0.0),),
        anchor_offsets: Sequence[Tuple[float, ...]] = (
            (0.16, -39.52, -1.78),),
        matched_thresholds: Sequence[float] = (0.6,),
        unmatched_thresholds: Sequence[float] = (0.45,),
        max_voxels: int = 16000,
        max_points_per_voxel: int = 32,
        anchor_area_threshold: float = 1.0,
        voxel_drop_order: str = "sorted",
    ):
        super().__init__()
        self.num_classes = num_classes
        self.grid_ny, self.grid_nx = grid_ny, grid_nx
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.box_code_size = box_code_size
        self.use_direction_classifier = use_direction_classifier
        self.max_voxels = max_voxels
        self.max_points_per_voxel = max_points_per_voxel
        self.voxel_drop_order = voxel_drop_order

        self.reader = PillarFeatureNet(9, pfn_filters)
        self.rpn = SECONDRPN(pfn_filters[-1], rpn_layer_nums, rpn_strides,
                             rpn_filters, rpn_up_strides, rpn_up_filters)
        a = num_anchor_per_loc
        c = self.rpn.out_channels
        self.conv_cls = Conv2d(c, a * num_classes, 1)
        self.conv_box = Conv2d(c, a * box_code_size, 1)
        self.conv_dir = Conv2d(c, a * 2, 1) if use_direction_classifier \
            else None

        # anchors at the RPN's output stride, static for the configuration
        factor = rpn_strides[0] // rpn_up_strides[0]
        feature_size = (grid_ny // factor, grid_nx // factor)
        configs = [ClassAnchorConfig(str(i), tuple(s), tuple(st),
                                     tuple(off), matched_threshold=mt,
                                     unmatched_threshold=ut)
                   for i, (s, st, off, mt, ut) in enumerate(zip(
                       anchor_sizes, anchor_strides, anchor_offsets,
                       matched_thresholds, unmatched_thresholds))]
        anchors = generate_anchors(feature_size, configs)["anchors"]
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        self.area_mask = make_grid_area_mask(
            (grid_ny, grid_nx), voxel_size, pc_range, feature_size, configs,
            anchor_area_threshold)
        if self.area_mask is None:
            raise NotImplementedError(
                "irregular anchor layouts need the padded voxelize path "
                "(anchors_bev_area_mask), which is not ported")

    def canvas_from_points(self, points: torch.Tensor,
                           points_mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Points (B, N, 4) + mask (B, N) -> (canvas (B, C, ny, nx) in
        channels_last memory, occupancy (B, ny, nx) f32 0/1)."""
        sv = voxelize_stream_batch(
            points, points_mask, self.voxel_size, self.pc_range,
            self.max_voxels, self.max_points_per_voxel,
            self.voxel_drop_order)
        h = self.reader.stream(sv.feats, sv.keep, sv.first,
                               bound=self.max_points_per_voxel)
        b, n, c = h.shape
        cells = self.grid_ny * self.grid_nx
        base = torch.arange(b, device=h.device)[:, None] * cells
        rows = torch.where(sv.last, sv.canvas_idx + base,
                           torch.full_like(sv.canvas_idx, b * cells))
        rows = rows.reshape(-1)
        flat = torch.zeros(b * cells + 1, c, dtype=h.dtype, device=h.device)
        flat.index_copy_(0, rows, h.reshape(b * n, c))
        occ = torch.zeros(b * cells + 1, dtype=torch.float32,
                          device=h.device)
        occ.index_fill_(0, rows, 1.0)
        canvas = flat[:b * cells].view(b, self.grid_ny, self.grid_nx, c)
        occ = occ[:b * cells].view(b, self.grid_ny, self.grid_nx)
        return canvas.permute(0, 3, 1, 2), occ

    def preds_from_canvas(self, canvas: torch.Tensor) -> Preds:
        """Canvas (B, C, ny, nx) -> flat per-anchor f32 predictions:
        cls_preds (B, A, classes), box_preds (B, A, 7), dir_preds (B, A, 2).
        The three 1x1 heads run as one conv over their concatenated
        kernels."""
        x = self.rpn(canvas)
        heads = [self.conv_cls, self.conv_box]
        widths = [self.num_classes, self.box_code_size]
        if self.use_direction_classifier:
            heads.append(self.conv_dir)
            widths.append(2)
        w = torch.cat([h.weight for h in heads]).to(x.dtype)
        bias = torch.cat([h.bias for h in heads]).to(x.dtype)
        y = F.conv2d(x, w, bias).permute(0, 2, 3, 1).float()
        b = y.shape[0]
        names = ("cls_preds", "box_preds", "dir_preds")
        out = {}
        c0 = 0
        for name, head, width in zip(names, heads, widths):
            ch = head.weight.shape[0]
            out[name] = y[..., c0:c0 + ch].reshape(b, -1, width)
            c0 += ch
        return out

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor
                ) -> Tuple[Preds, torch.Tensor]:
        """Points -> (predictions, anchor mask (B, A) bool)."""
        canvas, occ = self.canvas_from_points(points, points_mask)
        return self.preds_from_canvas(canvas), self.area_mask(occ)

    def decode_candidates(self, preds: Preds, anchors_mask: torch.Tensor,
                          nms_pre: int = 900) -> Preds:
        """Sigmoid scores (the best class per anchor), zero where the anchor
        mask is off, the top ``nms_pre`` (the lower anchor index first among
        equal scores), SECOND-decoded with the direction classifier's flip.
        Returns scores (B, K), anchor (B, K) indices, labels (B, K) and
        boxes (B, K, 7), K = min(nms_pre, A)."""
        scores_all = torch.sigmoid(preds["cls_preds"])
        top_scores, top_labels = scores_all.max(dim=-1)
        top_scores = torch.where(anchors_mask, top_scores,
                                 torch.zeros_like(top_scores))
        k_scores, k_idx = topk_lowest_index_first(
            top_scores, min(nms_pre, scores_all.shape[1]))
        boxes = second_box_decode(_take(preds["box_preds"], k_idx),
                                  self.anchors[k_idx])
        if self.use_direction_classifier:
            dir_lab = _take(preds["dir_preds"], k_idx).argmax(dim=-1)
            rot = boxes[..., 6]
            flip = (rot > 0) != (dir_lab == 1)
            rot = limit_period(torch.where(flip, rot + math.pi, rot), 0.5,
                               2 * math.pi)
            boxes = torch.cat([boxes[..., :6], rot[..., None]], dim=-1)
        return {"scores": k_scores, "anchor": k_idx, "boxes": boxes,
                "labels": torch.gather(top_labels, 1, k_idx)}

    def predict_from_preds(self, preds: Preds, anchors_mask: torch.Tensor,
                           score_threshold: float = 0.09,
                           nms_pre: int = 900, nms_post: int = 300,
                           nms_iou: float = 0.1) -> Dict:
        """``decode_candidates``, then rotated NMS of the candidates over
        ``score_threshold``, batched. Returns boxes (B, nms_post, 7),
        scores (B, nms_post), labels (B, nms_post) int32 (padding 0, 0, -1)
        and ``nms_passes``, the fixed point's passes for the batch."""
        cand = self.decode_candidates(preds, anchors_mask, nms_pre)
        nms_pre = cand["scores"].shape[1]
        bev = cand["boxes"][..., [0, 1, 3, 4, 6]].contiguous()
        keep_idx, _, passes = rotated_nms(bev, cand["scores"], nms_iou,
                                          score_threshold,
                                          min(nms_post, nms_pre))
        sel = keep_idx.clamp(0, nms_pre - 1)
        valid = keep_idx >= 0
        labels = torch.gather(cand["labels"], 1, sel).to(torch.int32)
        return {
            "boxes": torch.where(valid[..., None], _take(cand["boxes"], sel),
                                 0.0),
            "scores": torch.where(valid, torch.gather(cand["scores"], 1, sel),
                                  0.0),
            "labels": torch.where(valid, labels, -1),
            "nms_passes": passes,
        }

    @torch.inference_mode()
    def predict_from_points(self, points: torch.Tensor,
                            points_mask: torch.Tensor,
                            score_threshold: float = 0.09,
                            nms_pre: int = 900, nms_post: int = 300,
                            nms_iou: float = 0.1) -> Dict:
        """Raw padded points (B, N, 4) + mask (B, N) -> detections: the
        whole serving program (see ``predict_from_preds``)."""
        preds, amask = self(points, points_mask)
        return self.predict_from_preds(preds, amask, score_threshold,
                                       nms_pre, nms_post, nms_iou)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PointPillars":
        """flax's default initialisers, drawn from ``generator``:
        LeCun-normal kernels (the Dense, the convs, the transposed convs),
        zero biases, identity BN (scale 1, bias 0, mean 0, var 1)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                variance_scaling_(m.weight, 1.0, m.in_features, generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # Conv2d weight (O, I, kh, kw), ConvTranspose2d (I, O, kh,
                # kw): fan_in = I*kh*kw either way
                i = m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d)
                                   else 1]
                variance_scaling_(m.weight, 1.0, i * m.weight[0, 0].numel(),
                                  generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.BatchNorm2d, MaskedBatchNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, K) of ``t`` (B, A, C) -> (B, K, C)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
