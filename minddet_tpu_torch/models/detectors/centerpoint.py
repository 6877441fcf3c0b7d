"""CenterPoint from raw points or padded voxels, one- and two-stage,
serving and training (counterpart of
``minddet_tpu/models/detectors/centerpoint.py``: ``__call__``
(``forward_voxels``), ``predict``, ``loss``, ``unflip_task_map``,
``predict_tta_double_flip``, ``_bev_from_points_stream``,
``predict_from_points``, ``CenterPointTwoStage.predict_refined`` and the two
``loss_from_gt``).

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

    training (``loss_from_gt``): gt boxes -> per task the Gaussian heatmap
    and box targets -> the head's loss on the train-mode maps; two-stage:
    + the top ``num_proposals`` decoded boxes of the detached maps, sampled
    from the BEV map and refined -> a quality loss against the clipped
    rotated IoU with the best ground-truth box and a smooth-L1 box loss
    over the foreground proposals. The gradient reaches the BEV map through
    the row gather's backward and the PFN through the segment max's.

The canvas is built as PointPillars builds it (``ops/voxelize.py:
scatter_stream_canvas``); the reference's three canvas builders (compact,
sorted-add, ``.set``), its 65th scatter channel and ``rpn_space_to_depth``
are TPU layouts of the same canvas.

The padded path (``forward_voxels``, ``predict``, ``loss`` and the
double-flip TTA): padded voxels (``voxelize_batch``, first-come) ->
``decorate_pillar_features`` -> the padded two-layer PFN (its non-last
layer broadcasts each voxel's max back, no kernel) ->
``scatter_voxel_canvas`` -> the same RPN and head.

BN follows the module's mode (``train()`` / ``eval()``), where flax takes
``train=``. ``dtype`` is the reference's compute dtype over f32 parameters:
the decorated stream is cast to it and every layer computes in it (the
voxelizer, the targets, the decode and the losses stay f32). The
configuration's fields are the reference's, with its defaults (the nuScenes
model of ``configs/centerpoint_pp_nusc.yaml`` and
``centerpoint_pp_nusc_two_stage.yaml``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.heads.center_head import (CenterHead, Preds,
                                                        SepHead)
from minddet_tpu_torch.models.heads.second_stage import (BEVFeatureExtractor,
                                                         BEVRefineHead)
from minddet_tpu_torch.models.layers import init_flax_defaults_
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.models.readers.pillar_encoder import (
    PillarFeatureNet, scatter_voxel_canvas)
from minddet_tpu_torch.ops.box import second_box_decode, second_box_encode
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_bev
from minddet_tpu_torch.ops.targets import centerpoint_targets_batch
from minddet_tpu_torch.ops.voxelize import (VoxelizeOutput,
                                            decorate_pillar_features,
                                            scatter_stream_canvas,
                                            voxelize_batch,
                                            voxelize_stream_batch)

_BOX7 = [0, 1, 2, 3, 4, 5, 8]  # [x, y, z, w, l, h, yaw] of a 9-wide box
_BEV5 = [0, 1, 3, 4, 8]        # [x, y, w, l, yaw]
# the double-flip TTA's variants (x flipped, y flipped), in the batch's order
FLIPS = ((False, False), (False, True), (True, False), (True, True))
EXAMPLE_KEYS = ("hm", "anno_box", "ind", "mask", "cat")

Batch = Dict[str, torch.Tensor]
Loss = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def unflip_task_map(pred: Dict[str, torch.Tensor], fx: bool, fy: bool
                    ) -> Dict[str, torch.Tensor]:
    """One task's prediction maps (B, H, W, C), predicted on a cloud
    flipped in x (``fx``) and / or y (``fy``), back in the original frame:
    the axes flipped, the sub-cell offset ``reg`` of a flipped axis
    replaced by 1 - reg (on a range symmetric about 0 the mirrored cell is
    N - 1 - g), the yaw's sin negated by a y flip and its cos by an x
    flip, and each flipped axis's velocity negated."""
    dims = [d for d, f in ((1, fy), (2, fx)) if f]
    out = {}
    for k, m in pred.items():
        q = torch.flip(m, dims) if dims else m
        a, b = (q[..., 0], q[..., 1]) if k in ("reg", "rot", "vel") else \
            (None, None)
        if k == "reg":
            q = torch.stack([1.0 - a if fx else a, 1.0 - b if fy else b], -1)
        elif k == "rot":  # (sin, cos)
            q = torch.stack([-a if fy else a, -b if fx else b], -1)
        elif k == "vel":  # (vx, vy)
            q = torch.stack([-a if fx else a, -b if fy else b], -1)
        out[k] = q
    return out


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
        gaussian_overlap: float = 0.1,
        min_radius: float = 2.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.gaussian_overlap = gaussian_overlap
        self.min_radius = min_radius
        self.dtype = dtype
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
        self.reader = PillarFeatureNet(num_point_features + 5, pfn_filters,
                                       dtype=dtype)
        self.rpn = SECONDRPN(pfn_filters[-1], rpn_layer_nums, rpn_strides,
                             rpn_filters, rpn_up_strides, rpn_up_filters)
        self.head = CenterHead(self.rpn.out_channels, task_num_classes)

    def pillars_from_points(self, points: torch.Tensor,
                            points_mask: torch.Tensor):
        """Points (B, N, F) + mask (B, N) -> (stream voxels, the stream
        PFN's output (B, N, C): each pillar's feature at its last kept
        row). The voxelizer carries no gradient."""
        with torch.no_grad():
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

    @torch.no_grad()
    def voxelize(self, points: torch.Tensor,
                 points_mask: torch.Tensor) -> VoxelizeOutput:
        """Points (B, N, F) + mask (B, N) -> the padded voxels of the
        model's configuration (``voxelize_batch``, first-come)."""
        return voxelize_batch(points, points_mask, self.voxel_size,
                              self.pc_range, self.max_voxels,
                              self.max_points_per_voxel)

    def forward_voxels(self, voxels: torch.Tensor, num_points: torch.Tensor,
                       coords: torch.Tensor) -> Preds:
        """Padded voxels (B, V, P, F), point counts (B, V) and coords (B,
        V, 3) -> per task the six prediction maps (the reference's
        ``__call__``): decoration, the padded PFN, the scatter, the RPN and
        the head."""
        feats = decorate_pillar_features(voxels, num_points, coords,
                                         self.voxel_size, self.pc_range)
        canvas = scatter_voxel_canvas(self.reader(feats, num_points), coords,
                                      self.grid_ny, self.grid_nx)
        return self.head(self.rpn(canvas).contiguous(
            memory_format=torch.channels_last))

    def loss(self, batch: Batch) -> Loss:
        """The training objective from padded voxels and given targets:
        batch {voxels, num_points, coords, and per task the head's targets
        under hm, anno_box, ind, mask, cat (lists of length T)} -> (total,
        parts) of ``CenterHead.loss``."""
        preds = self.forward_voxels(batch["voxels"], batch["num_points"],
                                    batch["coords"])
        return self.head.loss(preds, {k: batch[k] for k in EXAMPLE_KEYS})

    @torch.inference_mode()
    def predict(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor, score_threshold: float = 0.1,
                nms_pre: int = 1000, nms_post: int = 83,
                nms_iou: float = 0.2) -> Dict:
        """Padded voxels -> detections, as ``predict_from_points``
        returns them."""
        return self._head_predict(
            self.forward_voxels(voxels, num_points, coords), score_threshold,
            nms_pre, nms_post, nms_iou)

    @torch.inference_mode()
    def predict_from_points_padded(self, points: torch.Tensor,
                                   points_mask: torch.Tensor,
                                   score_threshold: float = 0.1,
                                   nms_pre: int = 1000, nms_post: int = 83,
                                   nms_iou: float = 0.2) -> Dict:
        """Raw points -> detections by the padded path: ``voxelize``, then
        ``predict``."""
        vox = self.voxelize(points, points_mask)
        return self.predict(vox.voxels, vox.num_points, vox.coords,
                            score_threshold, nms_pre, nms_post, nms_iou)

    @torch.inference_mode()
    def predict_tta_double_flip(self, points: torch.Tensor,
                                points_mask: torch.Tensor,
                                score_threshold: float = 0.1,
                                nms_pre: int = 1000, nms_post: int = 83,
                                nms_iou: float = 0.2) -> Dict:
        """Double-flip test-time augmentation: the cloud as it is, flipped
        in y, in x and in both (``FLIPS``) go through the padded path as
        one 4B batch; each variant's maps are unflipped
        (``unflip_task_map``) and averaged in f32, the heatmap as
        logit(clip(mean(sigmoid), 1e-6, 1 - 1e-6)); one decode. Needs a BEV
        range symmetric about 0 on both axes (else ValueError)."""
        pcr = self.pc_range
        if abs(pcr[0] + pcr[3]) > 1e-4 or abs(pcr[1] + pcr[4]) > 1e-4:
            raise ValueError(f"double-flip TTA needs an x/y range symmetric "
                             f"about 0, got {pcr}")
        variants = []
        for fx, fy in FLIPS:
            q = points.clone()
            if fx:
                q[..., 0] = -q[..., 0]
            if fy:
                q[..., 1] = -q[..., 1]
            variants.append(q)
        b = points.shape[0]
        vox = self.voxelize(torch.cat(variants), points_mask.repeat(4, 1))
        merged = []
        for pred in self.forward_voxels(vox.voxels, vox.num_points,
                                        vox.coords):
            parts = [unflip_task_map(
                {k: m.float()[i * b:(i + 1) * b] for k, m in pred.items()},
                fx, fy) for i, (fx, fy) in enumerate(FLIPS)]
            out = {k: sum(p[k] for p in parts) / len(parts)
                   for k in parts[0] if k != "hm"}
            prob = sum(torch.sigmoid(p["hm"]) for p in parts) / len(parts)
            prob = prob.clamp(1e-6, 1.0 - 1e-6)
            out["hm"] = torch.log(prob) - torch.log1p(-prob)
            merged.append(out)
        return self._head_predict(merged, score_threshold, nms_pre, nms_post,
                                  nms_iou)

    def _stage1_example(self, batch: Batch) -> Dict[str, List[torch.Tensor]]:
        """gt boxes and classes -> the head's targets, per task: the boxes
        whose 1-based global class falls in the task's group, with the class
        counted within the group."""
        fh = self.grid_ny // self.out_size_factor
        fw = self.grid_nx // self.out_size_factor
        example = {"hm": [], "anno_box": [], "ind": [], "mask": [], "cat": []}
        classes = batch["gt_classes"]
        lo = 0
        for n in self.task_num_classes:
            in_task = (batch["gt_mask"].bool() & (classes > lo)
                       & (classes <= lo + n))
            tt = centerpoint_targets_batch(
                batch["gt_boxes"], (classes - lo - 1).clamp(0, n - 1),
                in_task, (fh, fw), n, self.pc_range, self.voxel_size,
                self.out_size_factor, self.gaussian_overlap, self.min_radius)
            for k in example:
                example[k].append(tt[k])
            lo += n
        return example

    def loss_from_gt(self, batch: Batch) -> Loss:
        """The training objective from raw points and boxes: batch {points
        (B, N, F) padded, points_mask (B, N), gt_boxes (B, G, 9) [x, y, z,
        w, l, h, vx, vy, yaw], gt_classes (B, G) 1-based global ids
        (sequential over the task groups), gt_mask (B, G)} -> (total,
        {task{t}_hm, task{t}_loc}). The targets are built on the device; BN
        as the module's mode says (train for the reference's
        ``train=True``)."""
        preds = self(batch["points"], batch["points_mask"])
        return self.head.loss(preds, self._stage1_example(batch))

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

    def __init__(self, *args, refine_hidden: int = 128,
                 num_proposals: int = 128, fg_iou: float = 0.55, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_proposals = num_proposals
        self.fg_iou = fg_iou
        self.extractor = BEVFeatureExtractor(self.pc_range, self.voxel_size,
                                             self.out_size_factor)
        self.refine = BEVRefineHead(5 * self.rpn.out_channels, refine_hidden,
                                    dtype=self.dtype)

    @torch.no_grad()
    def proposals(self, preds: Preds) -> torch.Tensor:
        """The second stage's training proposals: the top ``num_proposals``
        decoded boxes (B, K, 9) over all tasks, without NMS, from the
        detached maps."""
        return self.head.decode_boxes(
            preds, self.pc_range, self.voxel_size, self.out_size_factor,
            k=self.num_proposals)[0]

    def stage2_loss(self, bev: torch.Tensor, boxes: torch.Tensor,
                    batch: Batch) -> Dict[str, torch.Tensor]:
        """The second stage's two losses on given proposals ``boxes`` (B, K,
        9): each proposal is matched to the ground-truth box of the highest
        rotated BEV IoU (one launch of the intersection kernel, no
        gradient); ``stage2_score`` is the mean BCE-with-logits of the
        quality logit against clip(2 IoU - 0.5, 0, 1), ``stage2_box`` the
        smooth-L1 of the deltas against the SECOND residual of the matched
        box, summed per proposal and averaged over the foreground (IoU >=
        ``fg_iou``) ones."""
        slog, deltas = self.refine(self.extractor(bev, boxes))
        gt = batch["gt_boxes"].float()
        with torch.no_grad():
            boxes = boxes.float()
            iou = rotated_iou_bev(boxes[..., _BEV5].contiguous(),
                                  gt[..., _BEV5].contiguous())  # (B, K, G)
            iou = torch.where(batch["gt_mask"].bool()[:, None, :], iou, 0.0)
            miou, best = iou.max(dim=-1)
            starget = (2.0 * miou - 0.5).clamp(0.0, 1.0)
            matched = torch.gather(gt[..., _BOX7], 1,
                                   best[..., None].expand(-1, -1, 7))
            tgt = second_box_encode(matched, boxes[..., _BOX7])
            fg = (miou >= self.fg_iou).float()
        score_loss = (slog.clamp(min=0.0) - slog * starget
                      + torch.log1p(torch.exp(-slog.abs()))).mean()
        diff = deltas - tgt
        huber = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                            diff.abs() - 0.5)
        box_loss = (huber.sum(-1) * fg).sum() / fg.sum().clamp(min=1.0)
        return {"stage2_score": score_loss, "stage2_box": box_loss}

    def loss_from_gt(self, batch: Batch) -> Loss:
        """The single-stage loss plus the second stage's two (unit
        weights); parts also hold ``stage2_score`` and ``stage2_box``. The
        proposals are decoded from the detached maps, so the second stage's
        gradient reaches the network through the BEV map only."""
        bev = self.bev_from_points_stream(batch["points"],
                                          batch["points_mask"])
        preds = self.head(bev)
        total, parts = self.head.loss(preds, self._stage1_example(batch))
        stage2 = self.stage2_loss(bev, self.proposals(preds), batch)
        parts.update(stage2)
        return total + stage2["stage2_score"] + stage2["stage2_box"], parts

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
