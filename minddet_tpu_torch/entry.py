"""The flagship programs, ready to call.

``entry()`` is the serving program (counterpart of ``CenterNet.predict`` as
the reference jits it): CenterNet-ResNet18-DCNv2, 80 classes, 512x512,
bf16, top-100 decode. ``train_entry()`` is the train step that
``__graft_entry__.entry()`` and ``bench.py:headline_setup`` build: the same
model with f32 parameters and bf16 compute, targets made on the device from
synthetic boxes, focal + gathered-L1 loss, AdamW(5e-4) with clip-by-global-
norm 35 and the BN running-stat update. ``pointpillars_entry()`` is the
PointPillars serving program (``PointPillars.predict_from_points``): the
KITTI car model from raw points to (B, 300) rotated boxes, f32.
``centerpoint_entry()`` is the two-stage CenterPoint serving program
(``CenterPointTwoStage.predict_refined``): the nuScenes pillar model from
120,000 raw points to (B, 6 * 83) rescored and refined boxes, f32.
``centerpoint_train_entry()`` is the train step of that model as
``bench.py:bench_two_stage`` builds it (``CenterPointTwoStage.loss_from_gt``
under ``make_train_step``): f32 parameters, bf16 compute, batch 8, targets
and voxelization on the device, AdamW(1e-3) with clip-by-global-norm 35.

``centernet_dcn4_entry()`` and ``centernet_dcn4_train_entry()`` serve and
train CenterNet-R18 with DCN in all four backbone stages: the registered
``ResNet(depth=18, dcn_stages=(True,) * 4)`` of the JAX package in the place
of CenterNet's backbone, everything else as in ``entry()`` and
``train_entry()`` (80 classes, 512x512, bf16 compute). Stage 1's two
64-channel DCN layers, on the 128x128 map, take the flat sampler
(``hat_sample_2d``: 147,456 samples per image and layer); stages 2-4 and the
neck take the tap-grouped one, nine layers, as on the flagship path.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from minddet_tpu_torch.core.optim import adamw
from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.detectors.centerpoint import CenterPointTwoStage
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.ops.targets import centernet_targets_batch
from minddet_tpu_torch.train.loop import TrainState, make_train_step

RES = 512
NUM_CLASSES = 80
SEED = 0
OBJECTS = 128         # box slots per image (bench.py: o = 128)
VALID_OBJECTS = 8     # valid boxes per image (bench.py: n = 8)
CLOUD_POINTS = 18000  # points per cloud (bench.py: num_points=18000)
NUSC_CLOUD_POINTS = 120000  # configs/centerpoint_pp_nusc.yaml: num_points
NUSC_POINT_FEATURES = 5     # x, y, z, reflectance, sweep time
NUSC_MAX_GT = 64            # box slots per cloud (bench.py: max_gt=64)
NUSC_CLASSES = 10           # over the six tasks' (1, 2, 2, 1, 2, 2)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one it raises; the port never
    carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def _seeded_model(dtype: torch.dtype, dcn4: bool = False) -> CenterNet:
    model = CenterNet(num_classes=NUM_CLASSES, depth=18, dcn=True,
                      dtype=dtype)
    if dcn4:
        model.backbone = ResNet(depth=18, dcn_stages=(True,) * 4)
    return model.init_weights(torch.Generator().manual_seed(SEED))


def build_model(device=None, dtype: torch.dtype = torch.bfloat16,
                dcn4: bool = False) -> CenterNet:
    """The flagship CenterNet for serving (with ``dcn4``, the one with DCN
    in all four backbone stages): eval mode, weights from ``SEED`` stored in
    ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _seeded_model(dtype, dcn4).eval().to(
        device=dev, dtype=dtype, memory_format=torch.channels_last)


def _serving(model: CenterNet, batch: int):
    dev = next(model.parameters()).device
    gen = torch.Generator().manual_seed(SEED + 1)
    image = torch.randn(batch, RES, RES, 3, generator=gen).to(dev)
    return model.predict, (image,)


def entry(device=None, batch: int = 1
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor]]:
    """(predict_fn, args): ``predict_fn(*args)`` is (batch, 100, 6)
    [x1, y1, x2, y2, score, class] at output stride 4, in bf16."""
    return _serving(build_model(device), batch)


def centernet_dcn4_entry(device=None, batch: int = 1
                         ) -> Tuple[Callable[..., torch.Tensor],
                                    Tuple[torch.Tensor]]:
    """``entry()`` for CenterNet-R18 with DCN in all four backbone stages:
    (predict_fn, (image,)), ``predict_fn(image)`` (batch, 100, 6) in
    bf16."""
    return _serving(build_model(device, dcn4=True), batch)


def synthetic_boxes(batch: int, res: int = RES,
                    num_classes: int = NUM_CLASSES
                    ) -> Dict[str, np.ndarray]:
    """``bench.py:headline_setup``'s boxes, from numpy ``RandomState(1)``:
    OBJECTS slots per image, the first VALID_OBJECTS valid, xyxy in
    output-grid (stride 4) units, random classes."""
    rs = np.random.RandomState(1)
    wo = res // 4
    boxes = np.zeros((batch, OBJECTS, 4), np.float32)
    classes = rs.randint(0, num_classes, (batch, OBJECTS)).astype(np.int32)
    mask = np.zeros((batch, OBJECTS), bool)
    for b in range(batch):
        xy = rs.uniform(0, wo - 30, (VALID_OBJECTS, 2))
        wh = rs.uniform(4, 30, (VALID_OBJECTS, 2))
        boxes[b, :VALID_OBJECTS] = np.concatenate([xy, xy + wh], 1)
        mask[b, :VALID_OBJECTS] = True
    return {"boxes": boxes, "classes": classes, "mask": mask}


def centernet_loss(model: CenterNet, batch: Dict):
    """The train step's loss function: ``CenterNet.loss`` on a batch
    {"image", "targets"}."""
    return model.loss(batch["image"], batch["targets"])


def _train_program(device, batch: int, dcn4: bool
                   ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    dev = resolve_device(device)
    model = _seeded_model(torch.bfloat16, dcn4).to(
        device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, adamw(5e-4, clip_global_norm=35.0))
    boxes = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_boxes(batch).items()}
    out = RES // 4
    targets = centernet_targets_batch(boxes["boxes"], boxes["classes"],
                                      boxes["mask"], out, out, NUM_CLASSES,
                                      0.7)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    image = torch.randn(batch, RES, RES, 3, generator=gen, device=dev)
    return make_train_step(centernet_loss), (
        state, {"image": image, "targets": targets})


def train_entry(device=None, batch: int = 128
                ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one train
    step in place and returns ``(state, metrics)`` (loss, hm_loss, wh_loss,
    off_loss, grad_norm, on the device).

    The model is seeded with ``SEED``: f32 parameters, bf16 compute,
    channels_last, train mode. The targets are built on the device by
    ``centernet_targets_batch`` from ``synthetic_boxes``; the image is
    N(0, 1) drawn on the device from ``SEED``.
    """
    return _train_program(device, batch, dcn4=False)


def centernet_dcn4_train_entry(device=None, batch: int = 128
                               ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """``train_entry()`` for CenterNet-R18 with DCN in all four backbone
    stages: the same optimizer (AdamW 5e-4, clip-by-global-norm 35), f32
    parameters, bf16 compute, targets and image as there."""
    return _train_program(device, batch, dcn4=True)


def synthetic_clouds(batch: int, pc_range, num_points: int = CLOUD_POINTS,
                     seed: int = 0, num_features: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Point clouds as ``bench.py``'s PointPillars and CenterPoint setups
    draw them (``train/train.py:synthetic_points_batches``): numpy
    ``RandomState``, x, y, z uniform over ``pc_range``, reflectance in
    [0, 1), any further feature (the sweep time) in [0, 0.45), all valid.
    Returns points (batch, num_points, num_features) f32 and the mask (all
    True)."""
    return _draw_clouds(np.random.RandomState(seed), batch, pc_range,
                        num_points, num_features)


def _draw_clouds(rs: np.random.RandomState, batch: int, pc_range,
                 num_points: int, num_features: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    x0, y0, z0, x1, y1, z1 = pc_range
    size = (batch, num_points)
    feats = [rs.uniform(x0, x1, size), rs.uniform(y0, y1, size),
             rs.uniform(z0, z1, size), rs.uniform(0, 1, size)]
    while len(feats) < num_features:
        feats.append(rs.uniform(0, 0.45, size))
    return np.stack(feats, -1).astype(np.float32), np.ones(size, bool)


def build_pointpillars(device=None) -> PointPillars:
    """The KITTI car PointPillars of ``configs/pointpillars_car_kitti.yaml``
    (grid 496x432, PFN (64,), RPN (3, 5, 5), 107,136 anchors, max_voxels
    16000, 32 points per pillar, sorted drop order) in eval mode, f32,
    with flax's default initialisers drawn from ``SEED``."""
    dev = resolve_device(device)
    model = PointPillars().init_weights(torch.Generator().manual_seed(SEED))
    return model.eval().to(device=dev, memory_format=torch.channels_last)


def pointpillars_entry(device=None, batch: int = 1
                       ) -> Tuple[Callable[..., Dict],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """(predict_fn, (points, points_mask)): ``predict_fn(points,
    points_mask)`` is ``PointPillars.predict_from_points`` (score threshold
    0.09, top 900, NMS IoU 0.1, 300 kept): boxes (batch, 300, 7), scores,
    labels. The clouds are ``synthetic_clouds(batch)``."""
    model = build_pointpillars(device)
    dev = model.anchors.device
    points, mask = synthetic_clouds(batch, model.pc_range)
    return model.predict_from_points, (torch.from_numpy(points).to(dev),
                                       torch.from_numpy(mask).to(dev))


def build_centerpoint(device=None) -> CenterPointTwoStage:
    """The two-stage nuScenes CenterPoint of
    ``configs/centerpoint_pp_nusc_two_stage.yaml`` (grid 512x512, voxels
    0.2 x 0.2 x 8 m, PFN (64, 64), RPN (3, 5, 5) with up strides (0.5, 1,
    2), six tasks, max_voxels 30000, 20 points per pillar, sorted drop
    order, refine width 128) in eval mode, f32, with flax's default
    initialisers drawn from ``SEED`` and the heatmap biases at -2.19."""
    dev = resolve_device(device)
    model = CenterPointTwoStage().init_weights(
        torch.Generator().manual_seed(SEED))
    return model.eval().to(device=dev, memory_format=torch.channels_last)


def centerpoint_entry(device=None, batch: int = 1
                      ) -> Tuple[Callable[..., Dict],
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """(predict_fn, (points, points_mask)): ``predict_fn(points,
    points_mask)`` is ``CenterPointTwoStage.predict_refined`` (score
    threshold 0.1, top 1000 per task, NMS IoU 0.2, 83 kept per task): boxes
    (batch, 498, 9), scores, labels. The clouds are 120,000 points of 5
    features from ``synthetic_clouds``."""
    model = build_centerpoint(device)
    dev = next(model.parameters()).device
    points, mask = synthetic_clouds(batch, model.pc_range, NUSC_CLOUD_POINTS,
                                    num_features=NUSC_POINT_FEATURES)
    return model.predict_refined, (torch.from_numpy(points).to(dev),
                                   torch.from_numpy(mask).to(dev))


def synthetic_lidar_batch(batch: int, pc_range,
                          num_points: int = NUSC_CLOUD_POINTS,
                          max_gt: int = NUSC_MAX_GT,
                          num_classes: int = NUSC_CLASSES, seed: int = 0,
                          num_features: int = NUSC_POINT_FEATURES
                          ) -> Dict[str, np.ndarray]:
    """The first batch of the reference's
    ``train/train.py:synthetic_points_batches(box_dim=9)``, draw for draw
    from numpy ``RandomState(seed)``: the clouds of ``synthetic_clouds``,
    then per cloud 1 to ``max_gt`` - 1 car-sized boxes [x, y, z, w, l, h,
    vx, vy, yaw] (centres at least 5 m inside the range, velocities in
    [-2, 2), any yaw) in ``max_gt`` slots, then 1-based classes for every
    slot. Returns points, points_mask, gt_boxes, gt_classes, gt_mask."""
    rs = np.random.RandomState(seed)
    points, points_mask = _draw_clouds(rs, batch, pc_range, num_points,
                                       num_features)
    x0, y0, z0, x1, y1, _ = pc_range
    n = rs.randint(1, max_gt, batch)
    boxes = np.zeros((batch, max_gt, 9), np.float32)
    mask = np.zeros((batch, max_gt), bool)
    for i in range(batch):
        centres = rs.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (n[i], 2))
        velocity = rs.uniform(-2, 2, (n[i], 2))
        yaw = rs.uniform(-np.pi, np.pi, (n[i], 1))
        boxes[i, :n[i]] = np.concatenate(
            [centres, np.full((n[i], 1), z0 + 1.2),
             np.tile([1.6, 3.9, 1.56], (n[i], 1)), velocity, yaw], -1)
        mask[i, :n[i]] = True
    classes = rs.randint(1, num_classes + 1, (batch, max_gt))
    return {"points": points, "points_mask": points_mask, "gt_boxes": boxes,
            "gt_classes": classes.astype(np.int32), "gt_mask": mask}


def centerpoint_loss(model: CenterPointTwoStage, batch: Dict):
    """The CenterPoint train step's loss function:
    ``CenterPointTwoStage.loss_from_gt`` on a lidar batch."""
    return model.loss_from_gt(batch)


def centerpoint_train_entry(device=None, batch: int = 8
                            ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one
    two-stage CenterPoint train step in place and returns ``(state,
    metrics)`` (loss, task{t}_hm, task{t}_loc, stage2_score, stage2_box,
    grad_norm, on the device).

    The model is ``build_centerpoint``'s configuration seeded with
    ``SEED``: f32 parameters, bf16 compute, channels_last, train mode, 128
    proposals, foreground IoU 0.55. The batch is
    ``synthetic_lidar_batch(batch)``: 120,000 points of 5 features and up
    to 63 boxes per cloud; voxelization and targets run inside the step."""
    dev = resolve_device(device)
    model = CenterPointTwoStage(dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(SEED))
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, adamw(1e-3, clip_global_norm=35.0))
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_lidar_batch(batch, model.pc_range).items()}
    return make_train_step(centerpoint_loss), (state, data)
