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
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from minddet_tpu_torch.core.optim import adamw
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


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one it raises; the port never
    carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def _seeded_model(dtype: torch.dtype) -> CenterNet:
    model = CenterNet(num_classes=NUM_CLASSES, depth=18, dcn=True,
                      dtype=dtype)
    return model.init_weights(torch.Generator().manual_seed(SEED))


def build_model(device=None, dtype: torch.dtype = torch.bfloat16
                ) -> CenterNet:
    """The flagship CenterNet for serving: eval mode, weights from
    ``SEED`` stored in ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _seeded_model(dtype).eval().to(device=dev, dtype=dtype,
                                          memory_format=torch.channels_last)


def entry(device=None, batch: int = 1
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor]]:
    """(predict_fn, args): ``predict_fn(*args)`` is (batch, 100, 6)
    [x1, y1, x2, y2, score, class] at output stride 4, in bf16."""
    model = build_model(device)
    dev = next(model.parameters()).device
    gen = torch.Generator().manual_seed(SEED + 1)
    image = torch.randn(batch, RES, RES, 3, generator=gen).to(dev)
    return model.predict, (image,)


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
    dev = resolve_device(device)
    model = _seeded_model(torch.bfloat16).to(
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


def synthetic_clouds(batch: int, pc_range, num_points: int = CLOUD_POINTS,
                     seed: int = 0, num_features: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Point clouds as ``bench.py``'s PointPillars and CenterPoint setups
    draw them (``train/train.py:synthetic_points_batches``): numpy
    ``RandomState``, x, y, z uniform over ``pc_range``, reflectance in
    [0, 1), any further feature (the sweep time) in [0, 0.45), all valid.
    Returns points (batch, num_points, num_features) f32 and the mask (all
    True)."""
    rs = np.random.RandomState(seed)
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
