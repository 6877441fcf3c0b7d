"""PointPillars from raw points or padded voxels, serving and training
(counterpart of ``minddet_tpu/models/detectors/pointpillars.py``:
``__call__`` (``forward_voxels``), ``predict``, ``loss``,
``predict_from_points`` and ``loss_from_gt`` with both their branches,
``_canvas_from_points``, ``_preds_from_canvas``, ``_predict_from_preds``,
``_loss_from_preds`` and its helpers).

    points (B, N, 4) + mask -> stream voxelize -> stream PFN -> one canvas
    scatter (+ occupancy) -> SECOND RPN -> 1x1 cls/box/dir heads -> sigmoid,
    anchor-area mask, top-``nms_pre`` -> SECOND decode + direction flip ->
    rotated NMS (one K4 launch for the batch) -> (B, nms_post) boxes

    training (``loss_from_gt``): the same network on the batch's points,
    the anchor-area mask from the occupancy, the anchor assignment of the
    ground truth (nearest-BEV IoU, ``ops/anchors.py:assign_targets_batch``)
    -> sigmoid focal loss + sin-difference smooth L1 + the direction
    classifier's softmax cross entropy

The canvas is one (B, 64, ny, nx) map in ``channels_last`` memory, built by
one ``index_copy_`` of each pillar's last kept stream row (where the
running max holds the whole pillar's max); the occupancy map comes from the
same indices (``ops/voxelize.py:scatter_stream_canvas``). The reference's
TPU layouts (space-to-depth scatter, the 65th occupancy channel, the compact
scatter) compute the same canvas.

The padded path (the reference's dense branch, taken for an anchor layout
that is not a regular grid of whole cells, and by ``*_padded``): points ->
``voxelize_batch`` (first-come) -> ``decorate_pillar_features`` -> the
padded PFN -> ``scatter_voxel_canvas`` -> the same RPN and heads; the
anchor mask is ``anchors_bev_area_mask`` over the voxels' coords.

BN follows the module's mode (``train()`` / ``eval()``), where flax takes
``train=``. ``dtype`` is the reference's compute dtype over f32 parameters:
the decorated stream is cast to it and every layer computes in it; the
voxelizer, the anchor mask and the assignment carry no gradient, and the
losses are f32. The configuration's fields are the reference's, with its
defaults (the KITTI car model of ``configs/pointpillars_car_kitti.yaml``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minddet_tpu_torch.models.layers import (Conv2d, init_flax_defaults_,
                                             take_rows)
from minddet_tpu_torch.models.losses import (sigmoid_focal_loss,
                                             weighted_smooth_l1,
                                             weighted_softmax_ce)
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.models.readers.pillar_encoder import (
    PillarFeatureNet, scatter_voxel_canvas)
from minddet_tpu_torch.ops.anchors import (ClassAnchorConfig,
                                           anchors_bev_area_mask,
                                           assign_targets_batch,
                                           generate_anchors,
                                           make_grid_area_mask)
from minddet_tpu_torch.ops.box import (limit_period, rbbox_to_near_bbox,
                                       second_box_decode)
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import rotated_nms
from minddet_tpu_torch.ops.voxelize import (VoxelizeOutput,
                                            decorate_pillar_features,
                                            scatter_stream_canvas,
                                            voxelize_batch,
                                            voxelize_stream_batch)

Preds = Dict[str, torch.Tensor]
Loss = Tuple[torch.Tensor, Dict[str, torch.Tensor]]
ANCHOR_KEYS = ("anchors", "matched_threshold", "unmatched_threshold")


def add_sin_difference(preds: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SECOND's sin(a - b) on the yaw code: the last channel of ``preds``
    becomes sin(p) cos(t) and that of ``targets`` cos(p) sin(t), so that
    their difference is sin(p - t)."""
    rad_p = torch.sin(preds[..., -1:]) * torch.cos(targets[..., -1:])
    rad_t = torch.cos(preds[..., -1:]) * torch.sin(targets[..., -1:])
    return (torch.cat([preds[..., :-1], rad_p], dim=-1),
            torch.cat([targets[..., :-1], rad_t], dim=-1))


def get_direction_target(anchors: torch.Tensor, reg_targets: torch.Tensor
                         ) -> torch.Tensor:
    """One-hot (..., 2) f32 direction bins: bin 1 where the matched box's
    yaw (the residual plus the anchor's) is above 0."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    up = (rot_gt > 0).to(torch.float32)
    return torch.stack([1.0 - up, up], dim=-1)


def prepare_loss_weights(labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Labels (B, A) -> (cls weights, reg weights, cared): negatives and
    positives weigh 1 for the class loss, positives for the box loss, both
    over the sample's positive count (at least 1); cared is labels >= 0."""
    cared = labels >= 0
    positives = (labels > 0).to(torch.float32)
    negatives = (labels == 0).to(torch.float32)
    cls_weights = negatives + positives
    pos_norm = positives.sum(dim=1, keepdim=True).clamp(min=1.0)
    return cls_weights / pos_norm, positives / pos_norm, cared


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
        cls_weight: float = 1.0,
        loc_weight: float = 2.0,
        dir_weight: float = 0.2,
        focal_gamma: float = 2.0,
        focal_alpha: float = 0.25,
        smooth_l1_sigma: float = 3.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.cls_weight, self.loc_weight = cls_weight, loc_weight
        self.dir_weight = dir_weight
        self.focal_gamma, self.focal_alpha = focal_gamma, focal_alpha
        self.smooth_l1_sigma = smooth_l1_sigma
        self.num_classes = num_classes
        self.grid_ny, self.grid_nx = grid_ny, grid_nx
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.box_code_size = box_code_size
        self.use_direction_classifier = use_direction_classifier
        self.max_voxels = max_voxels
        self.max_points_per_voxel = max_points_per_voxel
        self.voxel_drop_order = voxel_drop_order
        self.anchor_area_threshold = anchor_area_threshold

        self.reader = PillarFeatureNet(9, pfn_filters, dtype=dtype)
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
        self.feature_size = (grid_ny // factor, grid_nx // factor)
        self.anchor_configs = [
            ClassAnchorConfig(str(i), tuple(s), tuple(st), tuple(off),
                              matched_threshold=mt, unmatched_threshold=ut)
            for i, (s, st, off, mt, ut) in enumerate(zip(
                anchor_sizes, anchor_strides, anchor_offsets,
                matched_thresholds, unmatched_thresholds))]
        feature_size, configs = self.anchor_layout()
        for k, v in generate_anchors(feature_size, configs).items():
            self.register_buffer(k, torch.from_numpy(v), persistent=False)
        # None for an irregular layout: then the points take the padded path
        self.area_mask = make_grid_area_mask(
            (grid_ny, grid_nx), voxel_size, pc_range, feature_size, configs,
            anchor_area_threshold)

    def canvas_from_points(self, points: torch.Tensor,
                           points_mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Points (B, N, 4) + mask (B, N) -> (canvas (B, C, ny, nx) in
        channels_last memory and ``dtype``, occupancy (B, ny, nx) f32 0/1).
        The voxelizer and the occupancy carry no gradient."""
        with torch.no_grad():
            sv = voxelize_stream_batch(
                points, points_mask, self.voxel_size, self.pc_range,
                self.max_voxels, self.max_points_per_voxel,
                self.voxel_drop_order)
        h = self.reader.stream(sv.feats, sv.keep, sv.first, sv.last,
                               bound=self.max_points_per_voxel)
        return scatter_stream_canvas(h, sv, self.grid_ny, self.grid_nx,
                                     occupancy=True)

    @torch.no_grad()
    def voxelize(self, points: torch.Tensor,
                 points_mask: torch.Tensor) -> VoxelizeOutput:
        """Points (B, N, 4) + mask (B, N) -> the padded voxels of the
        model's configuration (``voxelize_batch``, first-come)."""
        return voxelize_batch(points, points_mask, self.voxel_size,
                              self.pc_range, self.max_voxels,
                              self.max_points_per_voxel)

    def anchor_mask_from_coords(self, coords: torch.Tensor,
                                anchors: torch.Tensor = None
                                ) -> torch.Tensor:
        """Voxel coords (B, V, 3) -> the (B, A) anchor-area mask of any
        layout (``anchors_bev_area_mask`` over the nearest axis-aligned
        footprints of ``anchors``, the model's by default)."""
        anchors = self.anchors if anchors is None else anchors
        return anchors_bev_area_mask(
            coords, rbbox_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]]),
            (self.grid_ny, self.grid_nx), self.voxel_size, self.pc_range,
            self.anchor_area_threshold)

    def forward_voxels(self, voxels: torch.Tensor, num_points: torch.Tensor,
                       coords: torch.Tensor) -> Preds:
        """Padded voxels (B, V, P, 4), their point counts (B, V) and coords
        (B, V, 3) -> flat per-anchor f32 predictions (the reference's
        ``__call__``): decoration, the padded PFN, the scatter, then
        ``preds_from_canvas``."""
        feats = decorate_pillar_features(voxels, num_points, coords,
                                         self.voxel_size, self.pc_range)
        canvas = scatter_voxel_canvas(self.reader(feats, num_points), coords,
                                      self.grid_ny, self.grid_nx)
        return self.preds_from_canvas(canvas)

    def anchor_layout(self) -> Tuple[Tuple[int, int],
                                     List[ClassAnchorConfig]]:
        """(feature size, per-class anchor configs) at the RPN's output
        stride (``layer_strides[0] // upsample_strides[0]``)."""
        return self.feature_size, self.anchor_configs

    def anchor_set(self) -> Dict[str, torch.Tensor]:
        """The static anchor grid (A, 7) and its per-anchor matched and
        unmatched thresholds (A,), on the model's device."""
        return {k: getattr(self, k) for k in ANCHOR_KEYS}

    def preds_from_canvas(self, canvas: torch.Tensor,
                          cast_f32: bool = True) -> Preds:
        """Canvas (B, C, ny, nx) -> flat per-anchor predictions: cls_preds
        (B, A, classes), box_preds (B, A, 7), dir_preds (B, A, 2), in f32,
        or with ``cast_f32=False`` (the train path) in the compute dtype.
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
        y = F.conv2d(x, w, bias).permute(0, 2, 3, 1)
        if cast_f32:
            y = y.float()
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
        """Points -> (predictions, anchor mask (B, A) bool): the stream
        path and the grid mask, or for an irregular anchor layout the
        padded path (``voxelize``, ``forward_voxels``,
        ``anchor_mask_from_coords``), as the reference chooses."""
        if self.area_mask is None:
            vox = self.voxelize(points, points_mask)
            return (self.forward_voxels(vox.voxels, vox.num_points,
                                        vox.coords),
                    self.anchor_mask_from_coords(vox.coords))
        canvas, occ = self.canvas_from_points(points, points_mask)
        return self.preds_from_canvas(canvas), self.area_mask(occ)

    def loss_from_gt(self, batch: Dict[str, torch.Tensor]) -> Loss:
        """The training objective from raw points and boxes: batch {points
        (B, N, 4) padded, points_mask (B, N), gt_boxes (B, G, 7), gt_classes
        (B, G) 1-based, gt_mask (B, G)}, optionally with ``anchor_set()``'s
        keys (else the model's own) -> (total, {loc_loss, cls_loss,
        dir_loss}). BN as the module's mode says (train for the reference's
        ``train=True``). The stream path for a regular anchor grid, else
        ``loss_from_gt_padded``."""
        if self.area_mask is None:
            return self.loss_from_gt_padded(batch)
        gen = self._batch_anchors(batch)
        canvas, occ = self.canvas_from_points(batch["points"],
                                              batch["points_mask"])
        preds = self.preds_from_canvas(canvas, cast_f32=False)
        t = self._targets(gen, batch, self.area_mask(occ))
        return self.loss_from_preds(preds, gen["anchors"], t["labels"],
                                    t["bbox_targets"])

    def loss_from_gt_padded(self, batch: Dict[str, torch.Tensor]) -> Loss:
        """``loss_from_gt`` by the reference's dense branch: ``voxelize``,
        ``anchor_mask_from_coords``, the assignment, then ``loss`` on the
        voxels."""
        gen = self._batch_anchors(batch)
        vox = self.voxelize(batch["points"], batch["points_mask"])
        t = self._targets(gen, batch, self.anchor_mask_from_coords(
            vox.coords, gen["anchors"]))
        return self.loss({"voxels": vox.voxels, "num_points": vox.num_points,
                          "coords": vox.coords, "anchors": gen["anchors"],
                          "labels": t["labels"],
                          "reg_targets": t["bbox_targets"]})

    def _batch_anchors(self, batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        return ({k: batch[k] for k in ANCHOR_KEYS} if "anchors" in batch
                else self.anchor_set())

    @staticmethod
    def _targets(gen, batch, amask) -> Dict[str, torch.Tensor]:
        return assign_targets_batch(
            gen["anchors"], batch["gt_boxes"], batch["gt_classes"],
            batch["gt_mask"], gen["matched_threshold"],
            gen["unmatched_threshold"], amask)

    def loss(self, batch: Dict[str, torch.Tensor]) -> Loss:
        """The training objective from padded voxels and given targets:
        batch {voxels (B, V, P, 4), num_points (B, V), coords (B, V, 3),
        anchors (A, 7), labels (B, A), reg_targets (B, A, 7)} -> (total,
        parts), as ``loss_from_preds``."""
        preds = self.forward_voxels(batch["voxels"], batch["num_points"],
                                    batch["coords"])
        return self.loss_from_preds(preds, batch["anchors"], batch["labels"],
                                    batch["reg_targets"])

    def loss_from_preds(self, preds: Preds, anchors: torch.Tensor,
                        labels: torch.Tensor, reg_targets: torch.Tensor
                        ) -> Loss:
        """Predictions (in any dtype), anchors (A, 7), labels (B, A) and
        box targets (B, A, 7) -> (total, parts): each part summed over the
        batch, divided by the batch size and weighted (cls 1.0, loc 2.0,
        dir 0.2 by default); the class and box weights are normalised by
        each sample's positive count (``prepare_loss_weights``)."""
        b = labels.shape[0]
        cls_weights, reg_weights, cared = prepare_loss_weights(labels)
        cls_targets = torch.where(cared, labels, 0)
        classes = torch.arange(1, self.num_classes + 1,
                               device=labels.device)
        one_hot = (cls_targets[..., None] == classes).to(torch.float32)

        box_preds, reg_t = add_sin_difference(preds["box_preds"].float(),
                                              reg_targets)
        loc_loss = weighted_smooth_l1(box_preds, reg_t, weights=reg_weights,
                                      sigma=self.smooth_l1_sigma)
        loc = loc_loss.sum() / b * self.loc_weight
        cls_loss = sigmoid_focal_loss(preds["cls_preds"].float(), one_hot,
                                      weights=cls_weights,
                                      gamma=self.focal_gamma,
                                      alpha=self.focal_alpha)
        cls = cls_loss.sum() / b * self.cls_weight
        parts = {"loc_loss": loc, "cls_loss": cls}
        total = loc + cls
        if self.use_direction_classifier:
            dir_targets = get_direction_target(anchors, reg_targets)
            w = (labels > 0).to(torch.float32)
            w = w / w.sum(dim=-1, keepdim=True).clamp(min=1.0)
            dir_loss = weighted_softmax_ce(preds["dir_preds"], dir_targets,
                                           weights=w)
            parts["dir_loss"] = dir_loss.sum() / b * self.dir_weight
            total = total + parts["dir_loss"]
        return total, parts

    def decode_candidates(self, preds: Preds, anchors_mask: torch.Tensor,
                          nms_pre: int = 900,
                          anchors: torch.Tensor = None) -> Preds:
        """Sigmoid scores (the best class per anchor), zero where the anchor
        mask (None: every anchor) is off, the top ``nms_pre`` (the lower
        anchor index first among equal scores), SECOND-decoded against
        ``anchors`` (A, 7) (the model's by default) with the direction
        classifier's flip. Returns scores (B, K), anchor (B, K) indices,
        labels (B, K) and boxes (B, K, 7), K = min(nms_pre, A)."""
        anchors = self.anchors if anchors is None else anchors
        scores_all = torch.sigmoid(preds["cls_preds"])
        top_scores, top_labels = scores_all.max(dim=-1)
        if anchors_mask is not None:
            top_scores = torch.where(anchors_mask, top_scores,
                                     torch.zeros_like(top_scores))
        k_scores, k_idx = topk_lowest_index_first(
            top_scores, min(nms_pre, scores_all.shape[1]))
        boxes = second_box_decode(take_rows(preds["box_preds"], k_idx),
                                  anchors[k_idx])
        if self.use_direction_classifier:
            dir_lab = take_rows(preds["dir_preds"], k_idx).argmax(dim=-1)
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
                           nms_iou: float = 0.1,
                           anchors: torch.Tensor = None) -> Dict:
        """``decode_candidates``, then rotated NMS of the candidates over
        ``score_threshold``, batched. Returns boxes (B, nms_post, 7),
        scores (B, nms_post), labels (B, nms_post) int32 (padding 0, 0, -1)
        and ``nms_passes``, the fixed point's passes for the batch."""
        cand = self.decode_candidates(preds, anchors_mask, nms_pre, anchors)
        nms_pre = cand["scores"].shape[1]
        bev = cand["boxes"][..., [0, 1, 3, 4, 6]].contiguous()
        keep_idx, _, passes = rotated_nms(bev, cand["scores"], nms_iou,
                                          score_threshold,
                                          min(nms_post, nms_pre))
        sel = keep_idx.clamp(0, nms_pre - 1)
        valid = keep_idx >= 0
        labels = torch.gather(cand["labels"], 1, sel).to(torch.int32)
        return {
            "boxes": torch.where(valid[..., None],
                                 take_rows(cand["boxes"], sel), 0.0),
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
        whole serving program (see ``predict_from_preds``), by the route
        ``forward`` takes."""
        preds, amask = self(points, points_mask)
        return self.predict_from_preds(preds, amask, score_threshold,
                                       nms_pre, nms_post, nms_iou)

    @torch.inference_mode()
    def predict_from_points_padded(self, points: torch.Tensor,
                                   points_mask: torch.Tensor,
                                   score_threshold: float = 0.09,
                                   nms_pre: int = 900, nms_post: int = 300,
                                   nms_iou: float = 0.1) -> Dict:
        """``predict_from_points`` by the reference's dense branch:
        ``voxelize``, ``anchor_mask_from_coords`` over the model's anchors,
        then ``predict``."""
        vox = self.voxelize(points, points_mask)
        return self.predict(vox.voxels, vox.num_points, vox.coords,
                            self.anchors,
                            self.anchor_mask_from_coords(vox.coords),
                            score_threshold, nms_pre, nms_post, nms_iou)

    @torch.inference_mode()
    def predict(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor, anchors: torch.Tensor,
                anchors_mask: torch.Tensor = None,
                score_threshold: float = 0.09, nms_pre: int = 900,
                nms_post: int = 300, nms_iou: float = 0.1) -> Dict:
        """Padded voxels, point counts, coords, anchors (A, 7) and an
        optional anchor mask (B, A) -> detections (``forward_voxels``, then
        ``predict_from_preds``)."""
        preds = self.forward_voxels(voxels, num_points, coords)
        return self.predict_from_preds(preds, anchors_mask, score_threshold,
                                       nms_pre, nms_post, nms_iou, anchors)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PointPillars":
        """flax's default initialisers, drawn from ``generator``:
        LeCun-normal kernels (the Dense, the convs, the transposed convs),
        zero biases, identity BN (scale 1, bias 0, mean 0, var 1)."""
        init_flax_defaults_(self, generator)
        return self
