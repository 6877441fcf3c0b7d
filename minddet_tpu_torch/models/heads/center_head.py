"""CenterPoint's multi-task CenterHead (counterpart of
``minddet_tpu/models/heads/center_head.py``): a shared 3x3 conv + BN + ReLU,
then per task a ``SepHead`` with one branch per map (reg, height, dim, rot,
vel, hm), each (num_conv - 1) x (3x3 conv + BN + ReLU) and a final 3x3
conv; ``loss`` is the training objective (the gather-based focal loss on
each task's heatmap and the per-channel weighted L1 on its boxes);
``predict`` decodes every task's top ``nms_pre`` peaks to world boxes and
runs the rotated NMS.

Modules take an NCHW map in ``channels_last`` memory and return each
prediction map as its (B, H, W, C) view, the reference's layout. Module
names are the flax scopes (``shared_conv``, ``shared_bn``,
``task{t}.{name}_conv{i}`` / ``_bn{i}`` / ``_out``), so ``utils/convert.py``
carries the JAX model's variables over. BN has flax's defaults (eps 1e-5,
momentum 0.9) and follows the module's mode; the convs compute in their
input's dtype.

The reference's trace-time fusions (``fuse_branches``: one conv over the
branches' concatenated kernels, one fused BN, a block-diagonal out conv;
``_fused_tasks``: the same across tasks) are layouts for the TPU that
compute the same function from the same parameters (its tests pin them
equal; in train mode the fused BN takes each channel's batch statistics,
which are each branch's own); the port runs the per-branch form.

The rotated NMS runs once over all tasks: their candidates are stacked to
(T * B, nms_pre, 5), so a request costs one launch of the intersection
kernel and one fixed-point loop, whose passes are those of the slowest
(task, sample). Each (task, sample) converges to its own greedy NMS, so the
result is the reference's per-task NMS.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.layers import BatchNorm, Conv2d, take_rows
from minddet_tpu_torch.models.losses import (fast_focal_loss,
                                             gather_reg_loss_per_channel,
                                             sigmoid_clip)
from minddet_tpu_torch.ops.decode import (gather_feature, simple_topk,
                                          topk_lowest_index_first)
from minddet_tpu_torch.ops.nms import rotated_nms

BN_EPS = 1e-5      # flax BatchNorm default
BN_MOMENTUM = 0.1  # flax momentum 0.9

Preds = List[Dict[str, torch.Tensor]]

# per channel of [reg (2), height, dim (3), vel (2), rot (2)]
CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0)
COMMON_HEADS = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)),
                ("rot", (2, 2)), ("vel", (2, 2)))


class SepHead(nn.Module):
    """``heads``: name -> (out channels, num_conv). The ``hm`` branch's
    final bias starts at ``init_bias``."""

    def __init__(self, in_channels: int,
                 heads: Dict[str, Tuple[int, int]], head_conv: int = 64,
                 init_bias: float = -2.19):
        super().__init__()
        self.heads = dict(heads)
        self.init_bias = init_bias
        for name, (classes, num_conv) in self.heads.items():
            cin = in_channels
            for i in range(num_conv - 1):
                self.add_module(f"{name}_conv{i}",
                                Conv2d(cin, head_conv, 3, padding=1))
                self.add_module(f"{name}_bn{i}",
                                BatchNorm(head_conv, eps=BN_EPS,
                                          momentum=BN_MOMENTUM))
                cin = head_conv
            self.add_module(f"{name}_out", Conv2d(cin, classes, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, C, H, W) -> {name: (B, H, W, out channels)}."""
        out = {}
        for name, (_, num_conv) in self.heads.items():
            y = x
            for i in range(num_conv - 1):
                y = torch.relu(getattr(self, f"{name}_bn{i}")(
                    getattr(self, f"{name}_conv{i}")(y)))
            out[name] = getattr(self, f"{name}_out")(y).permute(0, 2, 3, 1)
        return out


def decode_task(pred: Dict[str, torch.Tensor], pc_range: Sequence[float],
                voxel_size: Sequence[float], out_size_factor: int, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One task's raw maps -> its top-k peaks as world boxes (B, K, 9)
    [x, y, z, w, l, h, vx, vy, yaw], scores (B, K) and within-task classes
    (B, K) int32: sigmoid scores, one global top-k, the regression maps
    gathered at the peaks, centre = (cell + reg) * out_size_factor * voxel +
    range_min, dims = exp, yaw = atan2(sin, cos)."""
    hm = torch.sigmoid(pred["hm"].float())
    scores, pos, cls, ys, xs = simple_topk(hm, k)
    reg, height, dim, rot, vel = (
        gather_feature(pred[n].float(), pos)
        for n in ("reg", "height", "dim", "rot", "vel"))
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    cx = (xs + reg[..., 0]) * out_size_factor * voxel_size[0] + pc_range[0]
    cy = (ys + reg[..., 1]) * out_size_factor * voxel_size[1] + pc_range[1]
    boxes = torch.cat([cx[..., None], cy[..., None], height, torch.exp(dim),
                       vel, yaw[..., None]], dim=-1)
    return boxes, scores, cls


class CenterHead(nn.Module):
    """The nuScenes head: six tasks over (1, 2, 2, 1, 2, 2) classes."""

    def __init__(self, in_channels: int = 384,
                 task_num_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
                 common_heads: Sequence[Tuple[str, Tuple[int, int]]] =
                 COMMON_HEADS,
                 share_conv_channel: int = 64, num_hm_conv: int = 2,
                 weight: float = 0.25,
                 code_weights: Sequence[float] = CODE_WEIGHTS):
        super().__init__()
        self.task_num_classes = tuple(task_num_classes)
        self.weight = weight  # of the box loss
        self.code_weights = tuple(code_weights)
        self.shared_conv = Conv2d(in_channels, share_conv_channel, 3,
                                  padding=1)
        self.shared_bn = BatchNorm(share_conv_channel, eps=BN_EPS,
                                   momentum=BN_MOMENTUM)
        for t, ncls in enumerate(self.task_num_classes):
            heads = dict(common_heads)
            heads["hm"] = (ncls, num_hm_conv)
            self.add_module(f"task{t}", SepHead(share_conv_channel, heads))

    def forward(self, x: torch.Tensor) -> Preds:
        """BEV map (B, C, H, W) -> per task {name: (B, H, W, channels)}."""
        x = torch.relu(self.shared_bn(self.shared_conv(x)))
        return [getattr(self, f"task{t}")(x)
                for t in range(len(self.task_num_classes))]

    def loss(self, preds: Preds, example: Dict[str, List[torch.Tensor]]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``example`` holds per task t the columns of
        ``ops.targets.centerpoint_targets_batch``: hm[t] (B, H, W, Ct),
        anno_box[t] (B, O, 10), ind[t], mask[t], cat[t] (B, O). Per task the
        focal loss on the clipped sigmoid of ``hm`` plus ``weight`` times the
        ``code_weights``-weighted per-channel L1 of [reg, height, dim, vel,
        rot] at the object centres. Returns (total, {task{t}_hm,
        task{t}_loc})."""
        total = 0.0
        parts = {}
        cw = torch.tensor(self.code_weights, dtype=torch.float32,
                          device=preds[0]["hm"].device)
        for t, pred in enumerate(preds):
            hm_loss = fast_focal_loss(
                sigmoid_clip(pred["hm"].float()), example["hm"][t],
                example["ind"][t], example["mask"][t], example["cat"][t])
            anno_pred = torch.cat([pred[n] for n in ("reg", "height", "dim",
                                                     "vel", "rot")], dim=-1)
            loc_loss = (gather_reg_loss_per_channel(
                anno_pred, example["mask"][t], example["ind"][t],
                example["anno_box"][t]) * cw).sum()
            total = total + hm_loss + self.weight * loc_loss
            parts[f"task{t}_hm"] = hm_loss
            parts[f"task{t}_loc"] = loc_loss
        return total, parts

    def decode_boxes(self, preds: Preds, pc_range: Sequence[float],
                     voxel_size: Sequence[float], out_size_factor: int = 4,
                     k: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The global top-k decoded boxes over all tasks, without NMS (the
        second stage's static-shape proposals): boxes (B, k, 9), scores
        (B, k), global labels (B, k) int32."""
        boxes_all, scores_all, labels_all = [], [], []
        offset = 0
        for pred in preds:
            boxes, scores, cls = decode_task(pred, pc_range, voxel_size,
                                             out_size_factor, k)
            boxes_all.append(boxes)
            scores_all.append(scores)
            labels_all.append(cls + offset)
            offset += pred["hm"].shape[-1]
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        labels = torch.cat(labels_all, dim=1)
        top, order = topk_lowest_index_first(scores, k)
        return take_rows(boxes, order), top, torch.gather(labels, 1, order)

    def candidates(self, preds: Preds, pc_range: Sequence[float],
                   voxel_size: Sequence[float], out_size_factor: int = 4,
                   post_center_range: Sequence[float] =
                   (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                   nms_pre: int = 1000) -> List[Dict[str, torch.Tensor]]:
        """Per task the NMS's input: ``decode_task``'s top ``nms_pre``
        boxes, scores (0.0 where the centre is outside
        ``post_center_range``) and global labels."""
        pcr = torch.tensor(post_center_range, dtype=torch.float32,
                           device=preds[0]["hm"].device)
        out = []
        offset = 0
        for pred in preds:
            boxes, scores, cls = decode_task(pred, pc_range, voxel_size,
                                             out_size_factor, nms_pre)
            in_range = ((boxes[..., :3] >= pcr[:3]).all(dim=-1)
                        & (boxes[..., :3] <= pcr[3:]).all(dim=-1))
            out.append({"boxes": boxes, "labels": cls + offset,
                        "scores": torch.where(in_range, scores,
                                              torch.zeros_like(scores))})
            offset += pred["hm"].shape[-1]
        return out

    def predict(self, preds: Preds, pc_range: Sequence[float],
                voxel_size: Sequence[float], out_size_factor: int = 4,
                score_threshold: float = 0.1,
                post_center_range: Sequence[float] =
                (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                nms_pre: int = 1000, nms_post: int = 83,
                nms_iou: float = 0.2) -> Dict:
        """Decode all tasks -> rotated NMS per task -> concatenate: boxes
        (B, T * nms_post, 9), scores, labels int32 (dropped slots 0, 0,
        -1), and ``nms_passes``, the fixed point's passes for the request.

        The tasks' candidates go through one NMS call, stacked on the
        batch axis; a task with fewer candidates than another (a tiny grid
        with fewer cells than ``nms_pre``) is padded with boxes of score
        -inf, which are never valid."""
        cands = self.candidates(preds, pc_range, voxel_size, out_size_factor,
                                post_center_range, nms_pre)
        b = cands[0]["scores"].shape[0]
        counts = [c["scores"].shape[1] for c in cands]
        kmax = max(counts)

        def padded(t, fill):
            pad = kmax - t.shape[1]
            if pad == 0:
                return t
            shape = (b, pad) + tuple(t.shape[2:])
            return torch.cat([t, t.new_full(shape, fill)], dim=1)

        bev = torch.cat([padded(c["boxes"][..., [0, 1, 3, 4, 8]], 0.0)
                         for c in cands]).contiguous()
        scores = torch.cat([padded(c["scores"], float("-inf"))
                            for c in cands])
        keep_idx, _, passes = rotated_nms(bev, scores, nms_iou,
                                          score_threshold,
                                          min(nms_post, kmax))
        out = {"boxes": [], "scores": [], "labels": []}
        for t, (c, n) in enumerate(zip(cands, counts)):
            keep = keep_idx[t * b:(t + 1) * b, :min(nms_post, n)]
            sel = keep.clamp(0, n - 1)
            ok = keep >= 0
            out["boxes"].append(torch.where(ok[..., None],
                                            take_rows(c["boxes"], sel), 0.0))
            out["scores"].append(torch.where(
                ok, torch.gather(c["scores"], 1, sel), 0.0))
            out["labels"].append(torch.where(
                ok, torch.gather(c["labels"], 1, sel), -1))
        det = {k: torch.cat(v, dim=1) for k, v in out.items()}
        det["nms_passes"] = passes
        return det
