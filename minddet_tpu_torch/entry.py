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
and voxelization on the device, AdamW(1e-3) with clip-by-global-norm 35;
``centerpoint_single_train_entry()`` the same step of the single-stage model
(``bench.py:bench_centerpoint_train``). ``pointpillars_train_entry()`` is the
PointPillars train step of ``bench.py:bench_pointpillars_train``
(``PointPillars.loss_from_gt``): the KITTI car model, f32 parameters, bf16
compute, batch 32, voxelization, anchor mask and target assignment on the
device, AdamW(2e-4). ``decode_nms_entry()`` is ``bench.py:
bench_decode_nms_p50``'s program: one task head's 128x128 maps decoded to
the top 1000 boxes and rotated NMS to 83, 20 times on perturbed heatmaps.

``centernet_dcn4_entry()`` and ``centernet_dcn4_train_entry()`` serve and
train CenterNet-R18 with DCN in all four backbone stages: the registered
``ResNet(depth=18, dcn_stages=(True,) * 4)`` of the JAX package in the place
of CenterNet's backbone, everything else as in ``entry()`` and
``train_entry()`` (80 classes, 512x512, bf16 compute). Stage 1's two
64-channel DCN layers, on the 128x128 map, take the flat sampler
(``hat_sample_2d``: 147,456 samples per image and layer); stages 2-4 and the
neck take the tap-grouped one, nine layers, as on the flagship path.

``faster_rcnn_entry()`` and ``mask_rcnn_entry()`` serve Faster R-CNN and
Mask R-CNN (``FasterRCNN.predict``) as ``bench.py:bench_faster_rcnn_infer``
and ``configs/faster_rcnn_r50_coco.yaml`` configure them: ResNet-50, FPN of
256 channels with one extra level, 80 classes, 512x512, bf16 compute; RPN
top 1000 per level before its NMS (IoU 0.7), 512 after; box head score
threshold 0.05, NMS 0.5, 100 detections; Mask R-CNN adds 28x28 masks. Their
ROIAlign is one row-gather kernel launch per pyramid level: four per
request, eight with the masks.

``faster_rcnn_train_entry()`` and ``mask_rcnn_train_entry()`` are their
train steps (``FasterRCNN.loss`` under ``make_train_step``) as
``configs/faster_rcnn_r50_coco.yaml``'s train section sets them, nothing
cut: the same model with f32 parameters and bf16 compute, batch 8, 256 ROI
samples per image, SGD with lr 0.01 (the schedule's value for its first 8
epochs), momentum 0.9 and weight decay 1e-4, no clip; the synthetic batch
of ``train/train.py`` (2 to 15 boxes per image in 128 slots, 64 with the
masks, and Mask R-CNN's GT bitmaps at a quarter of the image). Each step
launches the row-gather kernel once per pyramid level and roi set, its map
gradient as often, and Mask R-CNN's GT-bitmap crop once more.

``yolov8_entry()`` is ``bench.py:bench_yolov8s_infer``'s program:
YOLOv8-s (``YOLOv8(num_classes=80, image_hw=(640, 640))``, depth 0.33,
width 0.5) in bf16, ``YOLOv8.predict`` (top 1000 anchors, class-aware NMS
0.7 over score 0.01, 100 detections). ``yolov8_train_entry()`` is the train
step of ``configs/yolov8_s_coco.yaml`` as ``train/train.py --synthetic``
runs it, nothing cut: 640x640, 80 classes, batch 16, f32 parameters and
bf16 compute, SGD 0.937 with Nesterov momentum and weight decay 5e-4 under
the config's linear warm-up from step 0, inside the NaN guard. Neither
launches a hand-written kernel.

``yolox_entry()`` and ``yolov5_entry()`` serve YOLOX-s and YOLOv5-s
(``configs/yolox_s_coco.yaml``, ``configs/yolov5_s_coco.yaml``: depth 0.33,
width 0.5, 80 classes, 640x640) in bf16 on ``yolov8_entry``'s image:
YOLOX's ``predict`` (top 1000, class-aware NMS 0.65 over score 0.01, 100
detections) with its score biases calibrated (``calibrate_yolox``), and
YOLOv5's (top 1000, NMS 0.45 over 0.05, 100 detections) as seeded.
``yolox_train_entry()`` and ``yolov5_train_entry()`` are their configs' train
sections as ``train/train.py --synthetic`` runs them, nothing cut: batch 16,
f32 parameters and bf16 compute, Nesterov SGD (momentum 0.9 and 0.937) with
weight decay 5e-4 under the configs' warm-up cosine from step 0, inside the
NaN guard. None of the four launches a hand-written kernel.

``yolov3_entry()``, ``yolov4_entry()``, ``yolov7_entry()`` and
``ssd_entry()`` serve the configs ``yolov3_coco.yaml`` (Darknet-53, 416x416),
``yolov4_coco.yaml`` (CSPDarknet53 at width 1.0, 512x512),
``yolov7_coco.yaml`` (E-ELAN at width 0.5, 640x640) and
``ssd_mbv2_coco.yaml`` (MobileNetV2, 300x300), 80 classes, in bf16 on an
image of the config's size drawn as ``yolov8_entry``'s: the YOLOs' top
1000 and SSD's top 400 candidates, class-aware NMS 0.45 over score 0.05,
100 detections. ``yolov3_train_entry()``, ``yolov4_train_entry()``,
``yolov7_train_entry()`` and ``ssd_train_entry()`` are those configs' train
sections as ``train/train.py --synthetic`` runs them, nothing cut: f32
parameters and bf16 compute, batch 16 (SSD 32), SGD with the config's
momentum, Nesterov (YOLOv7 only), weight decay (5e-4, SSD's 4e-5) and
schedule counted from step 0 (YOLOv3's ``multi_epochs_decay``, the others'
``warmup_cosine``), inside the NaN guard. None of the eight launches a
hand-written kernel.

``deeplabv3plus_entry()``, ``deeplabv3_entry()`` and ``unet_entry()`` serve
the segmentors of ``configs/deeplabv3plus_r101.yaml``,
``deeplabv3_r101.yaml`` (ResNet-101 dilated to output stride 16, 21
classes, 513x513) and ``unet.yaml`` (widths 64-1024, 2 classes, 512x512):
``predict``, the per-pixel argmax, in bf16 on a ``RandomState(0)`` uint8
image normalized as the train path normalizes its records
(``data/seg.py:seg_normalize``). ``deeplabv3plus_train_entry()``,
``deeplabv3_train_entry()`` and ``unet_train_entry()`` are those configs'
train sections as ``train/train.py --synthetic`` runs them, nothing cut:
f32 parameters, bf16 compute, train-mode BN, one ``synthetic_seg_batches``
batch; DeepLab at batch 16 with SGD 0.9, weight decay 4e-5 and
``polynomial_decay(0.007, 0, 30000, 0.9)``, UNet at batch 8 with Adam under
``warmup_cosine(3e-4, 40000, 1000)``, inside the NaN guard. None of the six
launches a hand-written kernel.

``centernet_coco_train_entry()`` is the train step of
``configs/centernet_r18_coco.yaml`` fed by the COCO data path: the flagship
with f32 parameters and bf16 compute, batch 16, Adam 5e-4 without decay
under ``multi_epochs_decay(5e-4, [90, 120], 7400)`` from count 0, clip-by-
global-norm 35, inside the NaN guard; its batches come from the affine
route of ``train/synthetic.py:coco_batches`` over an in-memory set of
decoded COCO-like images (``synthetic_coco_records``: 640 x 640 canvas, 128
box slots, four loader threads). Each step launches the row-gather kernel
(K3f) once for the warp, and the sampler kernels as ``train_entry``.
``centernet_eval_entry()`` is ``train/evaluate.py:centernet_evaluate`` at
the reference's protocol (scale 1, keep-res buckets of 128 on a 1024 x 1024
canvas, batch 4, per-class Gaussian soft-NMS, the top-100 merge) for the
bf16 flagship on the same in-memory set: one K3f launch per batch for the
warp.

``build_pointpillars(config=...)`` reads a PointPillars configuration
(``configs/pointpillars_car_kitti.yaml``, the default, or
``pointpillars_ped_cycle_kitti.yaml``: 2 classes, grid 248x296, RPN strides
(1, 2, 2), 4 anchors per cell, 293,632 anchors); ``rpn_space_to_depth``,
a TPU layout of the same function, is not taken.
``pointpillars_ped_cycle_entry()`` serves the ped_cycle model as
``pointpillars_entry()`` serves the car one (one K4 launch per request).
``pointpillars_kitti_train_entry()`` is a configuration's own train
section, nothing cut: f32, batch 4, AdamW with decay 1e-4 under
``exponential_decay(2e-4, 27840, 0.8)`` inside the NaN guard, fed by
``kitti_batches`` over KITTI-like frames in memory (the GT database, the
sampler, the per-object noise, the global augmentation, four loader
threads); it launches no hand-written kernel.
``pointpillars_kitti_eval_entry()`` is ``kitti_evaluate`` (the official
KITTI table: bbox, BEV, 3D, AOS) over 256 in-memory frames: K4 once per
predict batch and once each for the BEV and 3D overlaps.

The padded voxel path of both lidar families: ``pointpillars_voxel_entry()``
serves a PointPillars configuration by the reference's dense branch
(``voxelize_batch``, the generic ``anchors_bev_area_mask``,
``PointPillars.predict``; f32, 18,000-point clouds; one K4 launch per
request); ``pointpillars_voxel_train_entry()`` is
``pointpillars_train_entry()``'s step on that route (``voxelize_batch``,
the generic mask, the assignment, ``PointPillars.loss``) on the same
batch; ``centerpoint_voxel_entry()`` serves the single-stage nuScenes
model of ``configs/centerpoint_pp_nusc.yaml`` from voxels
(``voxelize_batch``, 30000 x 20, ``CenterPoint.predict``) and
``centerpoint_tta_entry()`` by ``predict_tta_double_flip`` (a 4B voxel
batch of flipped clouds); both f32 on 120,000-point clouds of 5 features,
one K4 launch per request. ``build_centerpoint(config=...)`` reads a
CenterPoint configuration's model section (``_base_`` merged).

CenterPoint's nuScenes path: ``centerpoint_nusc_train_entry()`` is the
train section of ``configs/centerpoint_pp_nusc.yaml``, nothing cut (the
single-stage model, f32, batch 4, AdamW with decay 0.01 under
``one_cycle(2e-3, 140000)``, clip 35, the NaN guard, ``loss_from_gt``), fed
by ``nuscenes_batches`` (CBGS, the GT database and sampler, the global
augmentation, four loader threads) over nuScenes-like keyframes in memory;
each step launches K5f and K5b once. ``centerpoint_nusc_eval_entry(route)``
is ``nuscenes_evaluate`` (mAP, NDS and the TP errors) by the plain route
(``predict_from_points``: K5f and K4 once a batch), the double-flip TTA
(K4) or the two-stage model of ``..._two_stage.yaml`` (``predict_refined``:
K5f, K4 and K3f); ``centerpoint_nusc_tracking_entry()`` is
``nuscenes_tracking_evaluate`` (the greedy tracker, AMOTA) over one 20 s
scene of 40 keyframes.

CenterPoint's Waymo path, on ``configs/centerpoint_pp_waymo.yaml`` at
+-76.8 m and a 480 x 480 grid (``waymo_config``: the config's own 468 x
468 cannot be built): ``centerpoint_waymo_entry()`` serves it from raw
Waymo-like frames of 160,000 points (K5f and K4 once a request);
``centerpoint_waymo_train_entry()`` is its train section, nothing cut
(f32, batch 4, AdamW with decay 0.01 under ``one_cycle(3e-3, 280000)``,
clip 35, the NaN guard), fed by ``waymo_batches`` (the GT database and
sampler, the global augmentation, four loader threads) over frames in
memory: K5f and K5b once a step; ``centerpoint_waymo_eval_entry(route)`` is
``waymo_evaluate`` (L1 / L2 AP and APH) by the plain route or the refined
one of a two-stage model at the same geometry (K5f, K4 and K3f once a
batch, and K4 once per frame, class and level the protocol matches).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from minddet_tpu_torch.core.config import Config
from minddet_tpu_torch.core.lr_schedules import (Schedule, exponential_decay,
                                                  linear_warmup,
                                                  multi_epochs_decay,
                                                  one_cycle, polynomial_decay,
                                                  warmup_cosine)
from minddet_tpu_torch.core.optim import (Recipe, adam, adamw, sgd,
                                          skip_nonfinite_updates)
from minddet_tpu_torch.core.registry import DETECTORS
from minddet_tpu_torch.data.coco import CocoDetection
from minddet_tpu_torch.data.kitti import KittiDetection
from minddet_tpu_torch.data.nuscenes import NuScenesDetection
from minddet_tpu_torch.data.seg import seg_normalize
from minddet_tpu_torch.data.waymo import WaymoDetection
from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.models.detectors.faster_rcnn import (BOX_ROI,
                                                             FasterRCNN)
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.models.detectors.ssd import SSD
from minddet_tpu_torch.models.detectors.yolov3 import YOLOv3
from minddet_tpu_torch.models.detectors.yolov4 import YOLOv4
from minddet_tpu_torch.models.detectors.yolov5 import YOLOv5
from minddet_tpu_torch.models.detectors.yolov7 import YOLOv7
from minddet_tpu_torch.models.detectors.yolov8 import YOLOv8
from minddet_tpu_torch.models.detectors.yolox import YOLOX
from minddet_tpu_torch.models.segmentors import (DeepLabV3, DeepLabV3Plus,
                                                 UNet)
from minddet_tpu_torch.models.zoo import detector_kwargs
from minddet_tpu_torch.ops.decode import topk_lowest_index_first
from minddet_tpu_torch.ops.nms import rotated_nms
from minddet_tpu_torch.ops.targets import centernet_targets_batch
from minddet_tpu_torch.train.evaluate import (centernet_evaluate,
                                              kitti_evaluate,
                                              nuscenes_dataset,
                                              nuscenes_evaluate,
                                              nuscenes_tracking_evaluate,
                                              waymo_dataset, waymo_evaluate)
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import (COCO_SIZES, coco_batches,
                                               kitti_batches,
                                               nuscenes_batches,
                                               synthetic_coco_records,
                                               synthetic_detection_batch,
                                               synthetic_kitti_records,
                                               synthetic_nuscenes_records,
                                               synthetic_seg_batches,
                                               synthetic_waymo_records,
                                               waymo_batches)

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
# the R-CNN train steps (configs/faster_rcnn_r50_coco.yaml, train section)
RCNN_TRAIN_BATCH = 8
RCNN_GT_SLOTS = 128      # the COCO loader's max_objs default (data/coco.py)
MASK_RCNN_GT_SLOTS = 64  # configs/mask_rcnn_r50_coco.yaml: max_objs
RCNN_LR = 0.01           # multi_epochs_decay's value before epoch 8
RCNN_MOMENTUM = 0.9
RCNN_WEIGHT_DECAY = 1e-4
MASK_STRIDE = 4          # configs/mask_rcnn_r50_coco.yaml: mask_stride


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


# CenterNet's own train step and eval protocol (configs/centernet_r18_coco.yaml
# and train/evaluate.py:centernet_evaluate), fed from records in memory
COCO_TRAIN_BATCH = 16
COCO_LR = 5e-4                # multi_epochs_decay(5e-4, [90, 120], 7400)
COCO_MILESTONES = (90, 120)
COCO_STEPS_PER_EPOCH = 7400
COCO_CLIP = 35.0
COCO_MAX_OBJS = 128           # data.max_objs
COCO_WORKERS = 4              # the loader's default threads
COCO_IMAGES = 64              # images of the in-memory set
COCO_EVAL_CANVAS = (1024, 1024)  # centernet_evaluate's CocoDetection


def centernet_coco_train_entry(device=None, batch: int = COCO_TRAIN_BATCH,
                               images: int = COCO_IMAGES, res: int = RES
                               ) -> Tuple[Callable, Tuple[TrainState,
                                                          Iterator]]:
    """(step_fn, (state, batches)): ``step_fn(state, next(batches))`` runs
    one train step in place and returns ``(state, metrics)`` (loss,
    hm_loss, wh_loss, off_loss, grad_norm, on the device).

    ``configs/centernet_r18_coco.yaml``'s train section: the model seeded
    with ``SEED``, f32 parameters, bf16 compute, channels_last, train
    mode; Adam without decay, clip-by-global-norm 35, the lr
    ``multi_epochs_decay(5e-4, [90, 120], 7400)`` of the applied steps'
    count, inside ``skip_nonfinite_updates``; ``loss_from_gt``.
    ``batches`` is the affine route of ``coco_batches`` (``res`` x
    ``res``, seed ``SEED``, on the device) over
    ``synthetic_coco_records(images)`` read by ``COCO_WORKERS`` threads onto
    a 640 x 640 canvas with ``COCO_MAX_OBJS`` slots, epoch after epoch."""
    dev = resolve_device(device)
    model = _seeded_model(torch.bfloat16).to(
        device=dev, memory_format=torch.channels_last).train()
    tx = skip_nonfinite_updates(adam(
        multi_epochs_decay(COCO_LR, COCO_MILESTONES, COCO_STEPS_PER_EPOCH),
        clip_global_norm=COCO_CLIP))
    cfg = {"data": {"records": synthetic_coco_records(images, seed=SEED),
                    "max_objs": COCO_MAX_OBJS, "workers": COCO_WORKERS}}
    batches = coco_batches(cfg, batch, (res, res), seed=SEED, aug="affine",
                           device=dev)
    return make_train_step(model_gt_loss), (
        TrainState.create(model, tx), batches)


def centernet_eval_entry(device=None, images: int = COCO_IMAGES,
                         sizes: Sequence[Tuple[int, int]] = COCO_SIZES
                         ) -> Tuple[Callable[..., Dict[str, float]],
                                    Tuple[CenterNet, CocoDetection]]:
    """(evaluate_fn, (model, dataset)): ``evaluate_fn(model, dataset)`` is
    ``centernet_evaluate`` at its defaults, the reference's protocol, and
    returns the 12 COCO numbers. The model is ``build_model``'s bf16
    flagship; the dataset ``synthetic_coco_records(images, sizes=sizes)``
    (at the default sizes the train entry's images) on the (1024, 1024)
    canvas with ``COCO_MAX_OBJS`` slots, raw records kept."""
    model = build_model(device)
    ds = CocoDetection(synthetic_coco_records(images, seed=SEED, sizes=sizes),
                       max_hw=COCO_EVAL_CANVAS, max_objs=COCO_MAX_OBJS,
                       keep_raw=True)
    return centernet_evaluate, (model, ds)


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


CONFIGS = Path(__file__).resolve().parent.parent / "configs"
PP_CAR_CONFIG = CONFIGS / "pointpillars_car_kitti.yaml"
PP_PED_CYCLE_CONFIG = CONFIGS / "pointpillars_ped_cycle_kitti.yaml"


def read_config(config) -> Dict:
    """A configuration as plain dicts: ``config`` itself where it is a
    mapping, else the file at that path read by ``Config.fromfile`` (YAML,
    JSON or Python; its ``_base_`` files merged under it)."""
    if isinstance(config, Mapping):
        return dict(config)
    return Config.fromfile(str(config)).to_dict()


def pointpillars_config(config=PP_CAR_CONFIG) -> Dict:
    """A PointPillars configuration (``read_config``)."""
    return read_config(config)


def pointpillars_kwargs(cfg: Mapping) -> Dict:
    """The ``PointPillars`` arguments of a configuration's model section
    (``models/zoo.py:detector_kwargs``: lists as tuples; a key the port
    does not implement raises)."""
    return detector_kwargs(dict(cfg["model"], type="PointPillars"))


def build_pointpillars(device=None, config=PP_CAR_CONFIG) -> PointPillars:
    """The PointPillars of ``config`` (``pointpillars_config``; the KITTI
    car model of ``configs/pointpillars_car_kitti.yaml`` by default: grid
    496x432, PFN (64,), RPN (3, 5, 5), 107,136 anchors, max_voxels 16000, 32
    points per pillar, sorted drop order; ``pointpillars_ped_cycle_kitti``:
    2 classes, grid 248x296, RPN strides (1, 2, 2), 4 anchors per cell,
    293,632 anchors) in eval mode, f32, with flax's default initialisers
    drawn from ``SEED``."""
    dev = resolve_device(device)
    model = DETECTORS.build(dict(pointpillars_config(config)["model"],
                                 type="PointPillars")).init_weights(
        torch.Generator().manual_seed(SEED))
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


def pointpillars_ped_cycle_entry(device=None, batch: int = 1
                                ) -> Tuple[Callable[..., Dict],
                                           Tuple[torch.Tensor, torch.Tensor]]:
    """``pointpillars_entry()`` for the pedestrian and cyclist model of
    ``configs/pointpillars_ped_cycle_kitti.yaml``, nothing cut: the clouds
    are ``synthetic_clouds(batch)`` over its range."""
    model = build_pointpillars(device, PP_PED_CYCLE_CONFIG)
    dev = model.anchors.device
    points, mask = synthetic_clouds(batch, model.pc_range)
    return model.predict_from_points, (torch.from_numpy(points).to(dev),
                                       torch.from_numpy(mask).to(dev))


def pointpillars_voxel_entry(device=None, batch: int = 1,
                             config=PP_CAR_CONFIG
                             ) -> Tuple[Callable[..., Dict],
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """``pointpillars_entry()`` by the padded path, for any PointPillars
    configuration (``build_pointpillars``): ``predict_fn(points,
    points_mask)`` is ``PointPillars.predict_from_points_padded``, the
    reference's dense branch (``voxelize_batch`` at the config's max_voxels
    x points per pillar, ``anchors_bev_area_mask`` over the nearest
    footprints of every anchor, ``predict``). The clouds are
    ``synthetic_clouds(batch)`` over the config's range."""
    model = build_pointpillars(device, config)
    dev = model.anchors.device
    points, mask = synthetic_clouds(batch, model.pc_range)
    return model.predict_from_points_padded, (
        torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev))


CP_CONFIG = CONFIGS / "centerpoint_pp_nusc.yaml"
CP_TWO_STAGE_CONFIG = CONFIGS / "centerpoint_pp_nusc_two_stage.yaml"
CP_WAYMO_CONFIG = CONFIGS / "centerpoint_pp_waymo.yaml"


def build_centerpoint(device=None, config=None) -> CenterPoint:
    """The CenterPoint of ``config`` (``read_config``: a path or a mapping;
    ``configs/centerpoint_pp_nusc.yaml``, ``..._two_stage.yaml`` with its
    ``_base_``, ``centerpoint_pp_waymo.yaml``) built by ``DETECTORS``; by
    default the two-stage nuScenes model of ``CP_TWO_STAGE_CONFIG`` with
    the port's defaults (grid 512x512, voxels 0.2 x 0.2 x 8 m, PFN (64,
    64), RPN (3, 5, 5) with up strides (0.5, 1, 2), six tasks, max_voxels
    30000, 20 points per pillar, sorted drop order, refine width 128). In
    eval mode, f32, with flax's default initialisers drawn from ``SEED``
    and the heatmap biases at -2.19."""
    dev = resolve_device(device)
    if config is None:
        model = CenterPointTwoStage()
    else:
        model = DETECTORS.build(read_config(config)["model"])
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.eval().to(device=dev, memory_format=torch.channels_last)


def _nusc_clouds(model, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = next(model.parameters()).device
    points, mask = synthetic_clouds(batch, model.pc_range, NUSC_CLOUD_POINTS,
                                    num_features=NUSC_POINT_FEATURES)
    return torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev)


def centerpoint_voxel_entry(device=None, batch: int = 1
                            ) -> Tuple[Callable[..., Dict],
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """(predict_fn, (points, points_mask)): ``predict_fn(points,
    points_mask)`` is ``CenterPoint.predict_from_points_padded`` of the
    single-stage model of ``configs/centerpoint_pp_nusc.yaml``
    (``voxelize_batch``, 30000 voxels x 20 points, then ``predict``: score
    threshold 0.1, top 1000 per task, NMS IoU 0.2, 83 kept per task):
    boxes (batch, 498, 9), scores, labels. The clouds are 120,000 points
    of 5 features from ``synthetic_clouds``."""
    model = build_centerpoint(device, CP_CONFIG)
    return model.predict_from_points_padded, _nusc_clouds(model, batch)


def centerpoint_tta_entry(device=None, batch: int = 1
                          ) -> Tuple[Callable[..., Dict],
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """``centerpoint_voxel_entry()`` by double-flip TTA: ``predict_fn`` is
    ``CenterPoint.predict_tta_double_flip`` (4 * batch clouds voxelized
    and predicted as one batch, the maps unflipped and merged, one
    decode)."""
    model = build_centerpoint(device, CP_CONFIG)
    return model.predict_tta_double_flip, _nusc_clouds(model, batch)


def centerpoint_entry(device=None, batch: int = 1
                      ) -> Tuple[Callable[..., Dict],
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """(predict_fn, (points, points_mask)): ``predict_fn(points,
    points_mask)`` is ``CenterPointTwoStage.predict_refined`` (score
    threshold 0.1, top 1000 per task, NMS IoU 0.2, 83 kept per task): boxes
    (batch, 498, 9), scores, labels. The clouds are 120,000 points of 5
    features from ``synthetic_clouds``."""
    model = build_centerpoint(device)
    return model.predict_refined, _nusc_clouds(model, batch)


def synthetic_lidar_batch(batch: int, pc_range,
                          num_points: int = NUSC_CLOUD_POINTS,
                          max_gt: int = NUSC_MAX_GT,
                          num_classes: int = NUSC_CLASSES, seed: int = 0,
                          num_features: int = NUSC_POINT_FEATURES,
                          box_dim: int = 9) -> Dict[str, np.ndarray]:
    """The first batch of the reference's
    ``train/train.py:synthetic_points_batches``, draw for draw from numpy
    ``RandomState(seed)``: the clouds of ``synthetic_clouds``, then per
    cloud 1 to ``max_gt`` - 1 car-sized boxes in ``max_gt`` slots (centres
    at least 5 m inside the range, any yaw), [x, y, z, w, l, h, yaw] for
    ``box_dim=7`` and [x, y, z, w, l, h, vx, vy, yaw] for 9 (velocities in
    [-2, 2), drawn between the centres and the yaw), then 1-based classes
    for every slot. Returns points, points_mask, gt_boxes, gt_classes,
    gt_mask."""
    if box_dim not in (7, 9):
        raise ValueError(f"box_dim must be 7 or 9, got {box_dim}")
    rs = np.random.RandomState(seed)
    points, points_mask = _draw_clouds(rs, batch, pc_range, num_points,
                                       num_features)
    x0, y0, z0, x1, y1, _ = pc_range
    n = rs.randint(1, max_gt, batch)
    boxes = np.zeros((batch, max_gt, box_dim), np.float32)
    mask = np.zeros((batch, max_gt), bool)
    for i in range(batch):
        cols = [rs.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (n[i], 2)),
                np.full((n[i], 1), z0 + 1.2),
                np.tile([1.6, 3.9, 1.56], (n[i], 1))]
        if box_dim == 9:
            cols.append(rs.uniform(-2, 2, (n[i], 2)))
        cols.append(rs.uniform(-np.pi, np.pi, (n[i], 1)))
        boxes[i, :n[i]] = np.concatenate(cols, -1)
        mask[i, :n[i]] = True
    classes = rs.randint(1, num_classes + 1, (batch, max_gt))
    return {"points": points, "points_mask": points_mask, "gt_boxes": boxes,
            "gt_classes": classes.astype(np.int32), "gt_mask": mask}


def _centerpoint_train_program(cls, device, batch: int
                               ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    dev = resolve_device(device)
    model = cls(dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(SEED))
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, adamw(1e-3, clip_global_norm=35.0))
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_lidar_batch(batch, model.pc_range).items()}
    return make_train_step(model_gt_loss), (state, data)


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
    return _centerpoint_train_program(CenterPointTwoStage, device, batch)


def centerpoint_single_train_entry(device=None, batch: int = 8
                                   ) -> Tuple[Callable,
                                              Tuple[TrainState, Dict]]:
    """``centerpoint_train_entry()`` for the single-stage model of
    ``configs/centerpoint_pp_nusc.yaml`` (``bench.py:
    bench_centerpoint_train``): ``CenterPoint.loss_from_gt`` under the same
    optimizer (AdamW 1e-3, clip-by-global-norm 35), f32 parameters, bf16
    compute, the same batch; metrics loss, task{t}_hm, task{t}_loc,
    grad_norm. Per step its two-layer PFN launches the segment max and its
    backward once each, and nothing else."""
    return _centerpoint_train_program(CenterPoint, device, batch)


PP_TRAIN_LR = 2e-4    # bench.py:bench_pointpillars_train: adamw(2e-4)
PP_TRAIN_MAX_GT = 24  # box slots per cloud (bench.py: max_gt=24)


def pointpillars_train_entry(device=None, batch: int = 32
                             ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one
    PointPillars train step in place and returns ``(state, metrics)``
    (loss, loc_loss, cls_loss, dir_loss, grad_norm, on the device).

    The program of ``bench.py:bench_pointpillars_train``: the KITTI car
    model of ``build_pointpillars`` seeded with ``SEED``, f32 parameters,
    bf16 compute, channels_last, train mode; AdamW(2e-4) with the
    reference's weight decay 0.01 and no clip. The batch is
    ``synthetic_lidar_batch(batch, box_dim=7)``: 18,000 points of 4
    features and 1 to 23 cars per cloud in 24 slots, one class.
    Voxelization, the anchor mask and the assignment over the 107,136
    anchors run inside the step; it launches no hand-written kernel (a
    one-layer PFN takes the running max, the assignment axis-aligned
    IoUs)."""
    return _pointpillars_train_program(device, batch, model_gt_loss)


def padded_gt_loss(model, batch: Dict):
    """``model.loss_from_gt_padded(batch)``: the loss function of
    ``pointpillars_voxel_train_entry``."""
    return model.loss_from_gt_padded(batch)


def pointpillars_voxel_train_entry(device=None, batch: int = 32
                                   ) -> Tuple[Callable,
                                              Tuple[TrainState, Dict]]:
    """``pointpillars_train_entry()`` on the padded route, same model,
    optimizer and batch: ``PointPillars.loss_from_gt_padded``
    (``voxelize_batch`` at 16000 x 32, the generic ``anchors_bev_area_mask``,
    the assignment without gradient, then ``loss`` on the voxels: the
    padded PFN over (batch, 16000, 32, 9) decorated points). No
    hand-written kernel launches."""
    return _pointpillars_train_program(device, batch, padded_gt_loss)


def _pointpillars_train_program(device, batch: int, loss_fn
                                ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    dev = resolve_device(device)
    model = PointPillars(dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(SEED))
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, adamw(PP_TRAIN_LR))
    data = synthetic_lidar_batch(batch, model.pc_range, CLOUD_POINTS,
                                 PP_TRAIN_MAX_GT, num_classes=1,
                                 num_features=4, box_dim=7)
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return make_train_step(loss_fn), (state, data)


# the KITTI configs' own train section and eval protocol, fed from frames in
# memory (synthetic_kitti_records)
KITTI_TRAIN_FRAMES = 64   # frames of the in-memory train set
KITTI_EVAL_FRAMES = 256   # frames of the in-memory eval set: one chunk
KITTI_BATCH_KEYS = ("points", "points_mask", "gt_boxes", "gt_classes",
                    "gt_mask")


def kitti_optimizer(cfg: Mapping) -> Recipe:
    """The optimizer of a PointPillars configuration's train section, as
    the reference's ``build_optimizer`` + ``build_schedule`` make it:
    AdamW with the config's weight decay under ``exponential_decay(lr,
    decay_steps, decay_rate)``, inside the NaN guard (its default)."""
    tcfg = cfg["train"]
    ocfg, scfg = dict(tcfg["optimizer"]), dict(tcfg["lr_schedule"])
    if ocfg.pop("type") != "adamw" or scfg.pop("type") != \
            "exponential_decay":
        raise ValueError(f"not a PointPillars train section: {tcfg}")
    return skip_nonfinite_updates(adamw(exponential_decay(**scfg), **ocfg))


def kitti_device_batches(raw_batches: Iterator[Dict[str, np.ndarray]],
                         device) -> Iterator[Dict[str, torch.Tensor]]:
    """Each raw ``kitti_batches`` batch's arrays copied to ``device``."""
    for raw in raw_batches:
        yield {k: torch.from_numpy(raw[k]).to(device)
               for k in KITTI_BATCH_KEYS}


def pointpillars_kitti_train_entry(device=None, config=PP_CAR_CONFIG
                                   ) -> Tuple[Callable, Tuple[TrainState,
                                                              Iterator]]:
    """(step_fn, (state, batches)): ``step_fn(state, next(batches))`` runs
    one train step in place and returns ``(state, metrics)`` (loss,
    loc_loss, cls_loss, dir_loss, grad_norm, on the device).

    The configuration's train section, nothing cut (``config`` as
    ``build_pointpillars`` takes it, the car model by default): the model
    seeded with ``SEED``, f32 (no dtype is set), channels_last, train
    mode; ``kitti_optimizer`` (AdamW with decay 1e-4 under
    ``exponential_decay(2e-4, 27840, 0.8)``, the NaN guard);
    ``loss_from_gt``. ``batches`` are ``kitti_batches`` at the config's
    batch size (4) over ``synthetic_kitti_records(KITTI_TRAIN_FRAMES)`` of
    its classes (the GT database built from them, the sampler, the
    per-object noise, the global augmentation, the config's loader
    threads), copied to the device, epoch after epoch."""
    dev = resolve_device(device)
    cfg = pointpillars_config(config)
    model = build_pointpillars(dev, cfg).train()
    data = dict(cfg["data"])
    data["records"] = synthetic_kitti_records(KITTI_TRAIN_FRAMES, seed=SEED,
                                              classes=data["classes"])
    raw = kitti_batches({"data": data}, int(cfg["train"]["batch_size"]),
                        seed=SEED)
    return make_train_step(model_gt_loss), (
        TrainState.create(model, kitti_optimizer(cfg)),
        kitti_device_batches(raw, dev))


def pointpillars_kitti_eval_entry(device=None, config=PP_CAR_CONFIG
                                  ) -> Tuple[Callable[..., Dict],
                                             Tuple[PointPillars,
                                                   KittiDetection]]:
    """(evaluate_fn, (model, dataset)): ``evaluate_fn(model, dataset)`` is
    ``kitti_evaluate`` at the reference's protocol (batch 4, score
    threshold 0.3, bbox / bev / 3d and AOS) for the config's classes, and
    returns the table. The model is ``build_pointpillars(config)`` (f32,
    seeded); the dataset ``synthetic_kitti_records(KITTI_EVAL_FRAMES)`` of
    the config's classes with the raw labels kept."""
    cfg = pointpillars_config(config)
    classes = tuple(cfg["data"]["classes"])
    model = build_pointpillars(device, cfg)
    ds = KittiDetection(synthetic_kitti_records(KITTI_EVAL_FRAMES, seed=SEED,
                                                classes=classes),
                        keep_raw=True)
    return functools.partial(kitti_evaluate, classes=classes), (model, ds)



# the nuScenes config's own train section, eval protocols and tracking, fed
# from keyframes in memory (synthetic_nuscenes_records)
NUSC_TRAIN_FRAMES = 8  # keyframes of the in-memory train set (CBGS ~9x)
NUSC_TRAIN_SCENES = 2
NUSC_EVAL_FRAMES = 16   # keyframes of the in-memory eval set
NUSC_EVAL_SCENES = 2
NUSC_TRACK_FRAMES = 40  # one 20 s scene at 2 Hz
NUSC_ROUTES = {"plain": {}, "tta": {"tta": True}, "refined": {"refined": True}}


def nuscenes_optimizer(cfg: Mapping) -> Recipe:
    """The optimizer of a CenterPoint nuScenes (or Waymo) configuration's
    train section, as the reference's ``build_optimizer`` + ``build_schedule``
    make it: AdamW with the config's weight decay and global-norm clip
    under ``one_cycle(lr_max, total_steps)``, inside the NaN guard (its
    default)."""
    tcfg = cfg["train"]
    ocfg, scfg = dict(tcfg["optimizer"]), dict(tcfg["lr_schedule"])
    if ocfg.pop("type") != "adamw" or scfg.pop("type") != "one_cycle":
        raise ValueError(f"not a CenterPoint nuScenes train section: {tcfg}")
    return skip_nonfinite_updates(adamw(one_cycle(**scfg), **ocfg))


def centerpoint_nusc_train_entry(device=None
                                 ) -> Tuple[Callable, Tuple[TrainState,
                                                            Iterator]]:
    """(step_fn, (state, batches)): ``step_fn(state, next(batches))`` runs
    one train step in place and returns ``(state, metrics)`` (loss,
    task{t}_hm, task{t}_loc, grad_norm, on the device).

    The train section of ``configs/centerpoint_pp_nusc.yaml``, nothing cut:
    its single-stage model seeded with ``SEED``, f32 (no dtype is set),
    channels_last, train mode; ``nuscenes_optimizer`` (AdamW with decay
    0.01 and clip 35 under ``one_cycle(2e-3, 140000)``, the NaN guard);
    ``loss_from_gt``. ``batches`` are ``nuscenes_batches`` at the config's
    batch size (4) over ``synthetic_nuscenes_records(NUSC_TRAIN_FRAMES)``
    (CBGS, the GT database built from them with the config's
    ``min_points``, the sampler, the global augmentation, the config's
    loader threads), copied to the device, epoch after epoch."""
    dev = resolve_device(device)
    cfg = read_config(CP_CONFIG)
    model = build_centerpoint(dev, cfg).train()
    data = dict(cfg["data"])
    data["records"] = synthetic_nuscenes_records(
        NUSC_TRAIN_FRAMES, seed=SEED, scenes=NUSC_TRAIN_SCENES)
    raw = nuscenes_batches({"data": data}, int(cfg["train"]["batch_size"]),
                           seed=SEED)
    return make_train_step(model_gt_loss), (
        TrainState.create(model, nuscenes_optimizer(cfg)),
        kitti_device_batches(raw, dev))


def centerpoint_nusc_eval_entry(device=None, route: str = "plain"
                                ) -> Tuple[Callable[..., Dict],
                                           Tuple[CenterPoint,
                                                 NuScenesDetection]]:
    """(evaluate_fn, (model, dataset)): ``evaluate_fn(model, dataset)`` is
    ``nuscenes_evaluate`` at the reference's protocol (batch 2, score
    threshold 0.1) by ``route`` (NUSC_ROUTES): "plain"
    (``predict_from_points`` of the single-stage model of
    ``configs/centerpoint_pp_nusc.yaml``), "tta" (its double-flip TTA) or
    "refined" (``predict_refined`` of ``..._two_stage.yaml``'s model), and
    returns the metrics. The model is f32 and seeded; the dataset
    ``synthetic_nuscenes_records(NUSC_EVAL_FRAMES)`` without CBGS or
    augmentation."""
    if route not in NUSC_ROUTES:
        raise ValueError(f"route must be one of {sorted(NUSC_ROUTES)}, got "
                         f"{route!r}")
    model = build_centerpoint(device, CP_TWO_STAGE_CONFIG
                              if route == "refined" else CP_CONFIG)
    ds = nuscenes_dataset(synthetic_nuscenes_records(
        NUSC_EVAL_FRAMES, seed=SEED + 1, scenes=NUSC_EVAL_SCENES))
    return functools.partial(nuscenes_evaluate, **NUSC_ROUTES[route]), (
        model, ds)


def centerpoint_nusc_tracking_entry(device=None
                                    ) -> Tuple[Callable[..., Dict],
                                               Tuple[CenterPoint,
                                                     NuScenesDetection]]:
    """(evaluate_fn, (model, dataset)): ``evaluate_fn(model, dataset)`` is
    ``nuscenes_tracking_evaluate`` (``predict_from_points``, the greedy
    tracker, AMOTA) of the single-stage model of
    ``configs/centerpoint_pp_nusc.yaml`` (f32, seeded) over one scene of
    NUSC_TRACK_FRAMES keyframes from ``synthetic_nuscenes_records``."""
    model = build_centerpoint(device, CP_CONFIG)
    ds = nuscenes_dataset(synthetic_nuscenes_records(
        NUSC_TRACK_FRAMES, seed=SEED + 2, scenes=1))
    return nuscenes_tracking_evaluate, (model, ds)

# The Waymo pillar model: configs/centerpoint_pp_waymo.yaml with its range
# widened from +-74.88 m to +-76.8 m, the range of the JAX package's own
# Waymo tests (tests/test_waymo_path.py). At the config's 0.32 m pillars its
# own range gives a 468 x 468 grid, which the RPN's strides (2, 2, 2) do not
# divide: the up strides (0.5, 1, 2) then give maps of 117, 117 and 118
# cells, and their concatenation raises in both packages (ROADMAP.md §3).
# 480 / 8 = 60, so every level lines up and the heads sit at 120 x 120;
# the range still covers the config's.
WAYMO_RANGE_XY = 76.8
WAYMO_GRID = 480
# the second stage's keys of configs/centerpoint_pp_nusc_two_stage.yaml,
# taken by the refined route's model (no Waymo two-stage config exists)
TWO_STAGE_KEYS = ("type", "num_proposals", "fg_iou", "stage2_score_weight",
                  "stage2_box_weight", "refine_hidden")
WAYMO_TRAIN_FRAMES = 24  # frames of the in-memory train set: 6 steps an epoch
WAYMO_EVAL_FRAMES = 16   # frames of the in-memory eval set
WAYMO_ROUTES = {"plain": {}, "refined": {"refined": True}}


def waymo_config(two_stage: bool = False) -> Dict:
    """``configs/centerpoint_pp_waymo.yaml`` with its x / y range at
    +-WAYMO_RANGE_XY and its grid at WAYMO_GRID x WAYMO_GRID, every other key
    its own; with ``two_stage`` the model is ``CenterPointTwoStage`` with
    TWO_STAGE_KEYS of ``CP_TWO_STAGE_CONFIG``."""
    cfg = read_config(CP_WAYMO_CONFIG)
    m, r = cfg["model"], WAYMO_RANGE_XY
    m.update(pc_range=[-r, -r, m["pc_range"][2], r, r, m["pc_range"][5]],
             grid_ny=WAYMO_GRID, grid_nx=WAYMO_GRID)
    if two_stage:
        two = read_config(CP_TWO_STAGE_CONFIG)["model"]
        m.update({k: two[k] for k in TWO_STAGE_KEYS})
    return cfg


def waymo_clouds(batch: int, device, seed: int = SEED
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batch`` frames of ``synthetic_waymo_records(seed=seed)`` as
    ``WaymoDetection`` gives them to the model (160,000 points of 5
    features, subsampled from 160,000-180,000), on ``device``."""
    ds = waymo_dataset(synthetic_waymo_records(batch, seed=seed))
    exs = [ds[i] for i in range(batch)]
    return tuple(torch.from_numpy(np.stack([e[k] for e in exs])).to(device)
                 for k in ("points", "points_mask"))


def centerpoint_waymo_entry(device=None, batch: int = 1
                            ) -> Tuple[Callable[..., Dict],
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """(predict_fn, (points, points_mask)): ``predict_fn(points,
    points_mask)`` is ``CenterPoint.predict_from_points`` of the Waymo model
    (``waymo_config``: one task of VEHICLE, PEDESTRIAN, CYCLIST, 480 x 480
    pillars of 0.32 m, max_voxels 32000, 20 points a pillar; f32, seeded;
    score threshold 0.1, top 1000, NMS IoU 0.2, 83 kept): boxes (batch, 83,
    9), scores, labels. The clouds are ``waymo_clouds(batch)``."""
    model = build_centerpoint(device, waymo_config())
    return model.predict_from_points, waymo_clouds(
        batch, next(model.parameters()).device)


def centerpoint_waymo_train_entry(device=None
                                  ) -> Tuple[Callable, Tuple[TrainState,
                                                             Iterator]]:
    """(step_fn, (state, batches)): ``step_fn(state, next(batches))`` runs
    one train step in place and returns ``(state, metrics)`` (loss,
    task0_hm, task0_loc, grad_norm, on the device).

    The train section of ``configs/centerpoint_pp_waymo.yaml``, nothing cut,
    on ``waymo_config``'s model seeded with ``SEED``: f32 (no dtype is
    set), channels_last, train mode; ``nuscenes_optimizer`` (AdamW with
    decay 0.01 and clip 35 under ``one_cycle(3e-3, 280000)``, the NaN
    guard); ``loss_from_gt`` on 9-wide boxes with zero velocity (the head's
    velocity code weights apply, as in the reference). ``batches`` are
    ``waymo_batches`` at the config's batch size (4) over
    ``synthetic_waymo_records(WAYMO_TRAIN_FRAMES)`` (the GT database built
    from them with the config's ``min_points``, the sampler, the global
    augmentation, the config's loader threads), copied to the device,
    epoch after epoch."""
    dev = resolve_device(device)
    cfg = waymo_config()
    model = build_centerpoint(dev, cfg).train()
    data = dict(cfg["data"])
    data["records"] = synthetic_waymo_records(WAYMO_TRAIN_FRAMES, seed=SEED)
    raw = waymo_batches({"data": data}, int(cfg["train"]["batch_size"]),
                        seed=SEED)
    return make_train_step(model_gt_loss), (
        TrainState.create(model, nuscenes_optimizer(cfg)),
        kitti_device_batches(raw, dev))


def centerpoint_waymo_eval_entry(device=None, route: str = "plain"
                                 ) -> Tuple[Callable[..., Dict],
                                            Tuple[CenterPoint,
                                                  WaymoDetection]]:
    """(evaluate_fn, (model, dataset)): ``evaluate_fn(model, dataset)`` is
    ``waymo_evaluate`` at the reference's protocol (batch 2, score
    threshold 0.1, L1 / L2 AP and APH per class) by ``route``
    (WAYMO_ROUTES): "plain" (``predict_from_points`` of ``waymo_config``'s
    model) or "refined" (``predict_refined`` of ``CenterPointTwoStage`` at
    the same geometry with the second stage of
    ``configs/centerpoint_pp_nusc_two_stage.yaml``: 128 proposals, fg_iou
    0.55, refine width 128; no Waymo two-stage config exists), and returns
    the table. The model is f32 and seeded; the dataset
    ``synthetic_waymo_records(WAYMO_EVAL_FRAMES)`` without augmentation."""
    if route not in WAYMO_ROUTES:
        raise ValueError(f"route must be one of {sorted(WAYMO_ROUTES)}, got "
                         f"{route!r}")
    model = build_centerpoint(device, waymo_config(route == "refined"))
    ds = waymo_dataset(synthetic_waymo_records(WAYMO_EVAL_FRAMES,
                                               seed=SEED + 1))
    return functools.partial(waymo_evaluate, **WAYMO_ROUTES[route]), (
        model, ds)


# bench.py:bench_decode_nms_p50: one CenterPoint task head's decode and
# rotated NMS on a 128 x 128 map, chained over 20 perturbed heatmaps
DECODE_HW = 128
DECODE_NMS_PRE = 1000
DECODE_NMS_POST = 83
DECODE_ITERATIONS = 20
DECODE_NMS_IOU = 0.2
DECODE_SCORE_THRESHOLD = 0.1
DECODE_VOXEL = 0.8     # metres per map cell (and the size scale)
DECODE_ORIGIN = -51.2  # the range's lower corner


def decode_candidates_bev(hm: torch.Tensor, reg: torch.Tensor,
                          dim: torch.Tensor, rot: torch.Tensor,
                          nms_pre: int = DECODE_NMS_PRE
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One task head's maps hm (H, W), reg (H, W, 2), dim (H, W, 3), rot
    (H, W, 2) -> the top ``nms_pre`` sigmoid scores (the lower cell first
    among equal ones) and their BEV boxes [x, y, w, l, yaw] (nms_pre, 5):
    centre (cell + reg) * 0.8 - 51.2, sizes exp(dim) * 0.8, yaw
    atan2(rot)."""
    w = hm.shape[1]
    scores, idx = topk_lowest_index_first(torch.sigmoid(hm).reshape(-1),
                                          nms_pre)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    r2 = reg.reshape(-1, 2)[idx]
    d2 = torch.exp(dim.reshape(-1, 3)[idx]) * DECODE_VOXEL
    rr = rot.reshape(-1, 2)[idx]
    yaw = torch.atan2(rr[:, 0], rr[:, 1])
    cx = (xs + r2[:, 0]) * DECODE_VOXEL + DECODE_ORIGIN
    cy = (ys + r2[:, 1]) * DECODE_VOXEL + DECODE_ORIGIN
    return scores, torch.stack([cx, cy, d2[:, 0], d2[:, 1], yaw], -1)


def decode_nms(hm: torch.Tensor, reg: torch.Tensor, dim: torch.Tensor,
               rot: torch.Tensor, nms_pre: int = DECODE_NMS_PRE,
               nms_post: int = DECODE_NMS_POST
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``decode_candidates_bev``, then rotated NMS (IoU 0.2, score 0.1,
    ``nms_post`` kept: one K4 launch on the GPU). Returns (the scores at
    the kept indices clipped into [0, nms_pre), -1 padding taking index 0,
    summed as the reference sums them; the kept indices (nms_post,); the
    NMS's passes)."""
    scores, bev = decode_candidates_bev(hm, reg, dim, rot, nms_pre)
    keep, _, passes = rotated_nms(bev[None], scores[None], DECODE_NMS_IOU,
                                  DECODE_SCORE_THRESHOLD, nms_post)
    keep = keep[0]
    return scores[keep.clamp(0, nms_pre - 1)].sum(), keep, passes


def chained_decode_nms(hm: torch.Tensor, reg: torch.Tensor,
                       dim: torch.Tensor, rot: torch.Tensor,
                       iterations: int = DECODE_ITERATIONS,
                       nms_pre: int = DECODE_NMS_PRE,
                       nms_post: int = DECODE_NMS_POST
                       ) -> Tuple[torch.Tensor, List[int]]:
    """``bench.py:bench_decode_nms_p50``'s program: ``decode_nms`` on hm +
    0.01 i for i in range(iterations) (0.01 * i in f32, as the reference's
    loop computes it), the summed scores accumulated. Returns (the sum, a
    0-d f32 tensor on the maps' device; the NMS passes of each
    iteration)."""
    acc = torch.zeros((), dtype=torch.float32, device=hm.device)
    step = torch.tensor(0.01, dtype=torch.float32, device=hm.device)
    passes = []
    for i in range(iterations):
        total, _, p = decode_nms(hm + step * i, reg, dim, rot, nms_pre,
                                 nms_post)
        acc = acc + total
        passes.append(p)
    return acc, passes


def decode_nms_maps(hw: int = DECODE_HW, seed: int = 0
                    ) -> Tuple[np.ndarray, ...]:
    """The decode program's maps, in ``bench.py``'s draw order from numpy
    ``RandomState(seed)``: hm (hw, hw) N(0, 1), reg (hw, hw, 2) U[0, 1),
    dim (hw, hw, 3) U[0, 1), rot (hw, hw, 2) N(0, 1), all f32."""
    rs = np.random.RandomState(seed)
    hm = rs.randn(hw, hw).astype(np.float32)
    reg = rs.rand(hw, hw, 2).astype(np.float32)
    dim = rs.rand(hw, hw, 3).astype(np.float32)
    rot = rs.randn(hw, hw, 2).astype(np.float32)
    return hm, reg, dim, rot


def decode_nms_entry(device=None
                     ) -> Tuple[Callable[..., Tuple[torch.Tensor, List[int]]],
                                Tuple[torch.Tensor, ...]]:
    """(program, (hm, reg, dim, rot)): ``program(*maps)`` is
    ``chained_decode_nms`` (20 iterations, top 1000, 83 kept) on the
    maps of ``decode_nms_maps()`` on the device; per iteration K4 launches
    once at (1, 1000, 5)^2, and the NMS syncs the host once per pass."""
    dev = resolve_device(device)
    maps = tuple(torch.from_numpy(m).to(dev) for m in decode_nms_maps())
    return chained_decode_nms, maps


# the R-CNN's seeded heads, scaled on the request they serve (see
# calibrate_rcnn): RPN deltas, box-head class logits and box deltas, std
RPN_DELTA_STD = 0.2
CLS_LOGIT_STD = 2.0
BOX_DELTA_STD = 1.0


@torch.no_grad()
def calibrate_rcnn(model: FasterRCNN, image: torch.Tensor) -> FasterRCNN:
    """Give the seeded heads outputs that make a request do real work, on
    this image. Seeded weights over identity BN leave the head outputs at
    whatever scale the backbone's activations reach: RPN deltas that throw
    the proposals off the image, and class logits that the softmax turns
    into ~1/81 each, under the 0.05 threshold, so that ``predict`` keeps
    nothing. So the RPN's ``reg`` conv is scaled to deltas of std
    ``RPN_DELTA_STD``, then, on the proposals that follows, the box head's
    ``cls`` layer to logits of std ``CLS_LOGIT_STD`` and its ``reg`` to
    deltas of std ``BOX_DELTA_STD`` (over the proposals that are not
    padding). Returns ``model``, changed in place."""
    with torch.inference_mode():
        _, _, deltas = model(image)
        gain = RPN_DELTA_STD / float(deltas.std())
    model.rpn.reg.weight.mul_(gain)
    model.rpn.reg.bias.mul_(gain)
    with torch.inference_mode():
        pyramids, logits, deltas = model(image)
        proposals, _, _ = model.proposals(logits, deltas)
        feats = model.roi_features(pyramids, proposals, BOX_ROI)
        cls, reg = model.box_head(feats.to(model.dtype))
        real = proposals.abs().sum(-1) > 0
        gains = (CLS_LOGIT_STD / float(cls[real].std()),
                 BOX_DELTA_STD / float(reg[real].std()))
    for layer, g in zip((model.box_head.cls, model.box_head.reg), gains):
        layer.weight.mul_(g)
        layer.bias.mul_(g)
    return model


def build_faster_rcnn(device=None, with_mask: bool = False,
                      dtype: torch.dtype = torch.bfloat16) -> FasterRCNN:
    """Faster R-CNN (with ``with_mask``, Mask R-CNN) ResNet-50-FPN, 80
    classes, 512x512, RPN top 1000 per level and 512 after its NMS, in eval
    mode: weights from ``SEED`` stored in ``dtype``, which is also the
    compute dtype; not calibrated (``calibrate_rcnn``)."""
    dev = resolve_device(device)
    model = FasterRCNN(num_classes=NUM_CLASSES, depth=50,
                       image_hw=(RES, RES), rpn_pre_nms=1000,
                       rpn_post_nms=512, with_mask=with_mask, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.eval().to(device=dev, dtype=dtype,
                           memory_format=torch.channels_last)


def _rcnn_serving(with_mask: bool, device, batch: int):
    model = build_faster_rcnn(device, with_mask)
    dev = next(model.parameters()).device
    gen = torch.Generator().manual_seed(SEED + 1)
    image = torch.randn(batch, RES, RES, 3, generator=gen).to(dev)
    return calibrate_rcnn(model, image).predict, (image,)


def faster_rcnn_entry(device=None, batch: int = 1
                      ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is
    ``FasterRCNN.predict`` (score threshold 0.05, NMS 0.5, 100 detections):
    boxes (batch, 100, 4) in input pixels, scores, labels (-1 in empty
    slots), ``nms_passes`` (the RPN's NMS, the box head's). The image is
    N(0, 1) from ``SEED + 1``, (batch, 512, 512, 3); the model is
    ``build_faster_rcnn``'s in bf16, calibrated on that image
    (``calibrate_rcnn``) so that every request keeps detections."""
    return _rcnn_serving(False, device, batch)


def mask_rcnn_entry(device=None, batch: int = 1
                    ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """``faster_rcnn_entry()`` for Mask R-CNN: the result also has masks
    (batch, 100, 28, 28), each the sigmoid of its label's mask logits in
    its box's coordinates."""
    return _rcnn_serving(True, device, batch)


def rcnn_loss(model: FasterRCNN, batch: Dict):
    """The R-CNN train steps' loss function: ``FasterRCNN.loss`` on a batch
    {"image", "gt_boxes", "gt_classes", "gt_mask"[, "gt_bitmaps"]} with
    its uniform draws from ``batch["draws"]`` where given, else drawn anew
    from ``batch["generator"]`` (``FasterRCNN.sampling_draws``), as the
    reference folds the step into its sampling key."""
    draws = batch.get("draws")
    if draws is None:
        draws = model.sampling_draws(batch["image"].shape[0],
                                     batch["gt_boxes"].shape[1],
                                     batch["generator"])
    return model.loss(batch, draws)


def synthetic_rcnn_batch(batch: int, with_mask: bool,
                         res: int = RES) -> Dict[str, np.ndarray]:
    """The R-CNN train steps' batch: ``synthetic_detection_batch`` from
    ``SEED`` at res x res, 80 classes, ``RCNN_GT_SLOTS`` slots
    (``MASK_RCNN_GT_SLOTS`` and the GT bitmaps at ``MASK_STRIDE`` with the
    masks)."""
    return synthetic_detection_batch(
        batch, (res, res), NUM_CLASSES, seed=SEED, with_masks=with_mask,
        mask_stride=MASK_STRIDE,
        slots=MASK_RCNN_GT_SLOTS if with_mask else RCNN_GT_SLOTS)


# the train entries' heads: N(0, std) kernels, zero biases, as detectron
# initialises the RPN and the box predictor
HEAD_INIT_STD = 0.01
BOX_DELTA_INIT_STD = 0.001


@torch.no_grad()
def seed_rcnn_for_training(model: FasterRCNN, generator: torch.Generator
                           ) -> FasterRCNN:
    """The starting weights of the R-CNN train entries, drawn from
    ``generator`` after ``init_weights``: every Bottleneck's last BN scale
    at 0, so that each residual block starts as the identity (Goyal et al.,
    2017; torchvision's ``zero_init_residual``), and the RPN's and the box
    head's layers at N(0, ``HEAD_INIT_STD``), the box deltas' at N(0,
    ``BOX_DELTA_INIT_STD``), biases 0 (detectron's R-CNN heads). From
    flax's defaults alone, which the reference's ``init`` draws, SGD at the
    config's lr 0.01 diverges within a few steps, in the reference as in
    the port: the heads' outputs start at the scale of the FPN's features
    and the backbone's gradient norm near 2,000. The mask head keeps
    flax's defaults. Returns ``model``, changed in place."""
    for name, m in model.backbone.named_modules():
        if name.endswith(".bn3"):
            m.weight.zero_()
    layers = [model.rpn.conv, model.rpn.cls, model.rpn.reg,
              model.box_head.fc1, model.box_head.fc2, model.box_head.cls]
    for layer in layers + [model.box_head.reg]:
        std = BOX_DELTA_INIT_STD if layer is model.box_head.reg \
            else HEAD_INIT_STD
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()
    return model


def _rcnn_train_program(with_mask: bool, device, batch: int
                        ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    dev = resolve_device(device)
    model = FasterRCNN(num_classes=NUM_CLASSES, depth=50,
                       image_hw=(RES, RES), rpn_pre_nms=1000,
                       rpn_post_nms=512, roi_samples=256, with_mask=with_mask,
                       mask_stride=MASK_STRIDE, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(SEED))
    seed_rcnn_for_training(model, torch.Generator().manual_seed(SEED + 2))
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, sgd(
        RCNN_LR, momentum=RCNN_MOMENTUM, weight_decay=RCNN_WEIGHT_DECAY))
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_rcnn_batch(batch, with_mask).items()}
    data["generator"] = torch.Generator(device=dev).manual_seed(SEED)
    return make_train_step(rcnn_loss), (state, data)


def faster_rcnn_train_entry(device=None, batch: int = RCNN_TRAIN_BATCH
                            ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one Faster
    R-CNN train step in place and returns ``(state, metrics)`` (loss,
    rpn_cls, rpn_reg, roi_cls, roi_reg, grad_norm, on the device).

    ResNet-50-FPN, 80 classes, 512 x 512, RPN top 1000 per level and 512
    after its NMS, 256 ROI samples per image, seeded with ``SEED``
    (``seed_rcnn_for_training``): f32 parameters, bf16 compute,
    channels_last, train mode; SGD lr 0.01,
    momentum 0.9, weight decay 1e-4 on ndim > 1 parameters, no clip. The
    batch is ``synthetic_rcnn_batch(batch, False)`` and a generator on the
    device from ``SEED``, which gives each step its sampling draws."""
    return _rcnn_train_program(False, device, batch)


def mask_rcnn_train_entry(device=None, batch: int = RCNN_TRAIN_BATCH
                          ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """``faster_rcnn_train_entry()`` for Mask R-CNN: 64 GT slots and the GT
    bitmaps (batch, 128, 128, 64) f32; the metrics add the mask loss."""
    return _rcnn_train_program(True, device, batch)


# YOLOv8-s: bench.py:bench_yolov8s_infer and configs/yolov8_s_coco.yaml
YOLO_RES = 640
YOLO_TRAIN_BATCH = 16
YOLO_LR = 0.01          # lr_schedule: linear_warmup(0.01, 22000, 3.6e6,
YOLO_WARMUP = 22000     # end_factor 0.01), counted from step 0 as
YOLO_TOTAL_STEPS = 3_600_000  # train/train.py runs it
YOLO_END_FACTOR = 0.01
YOLO_MOMENTUM = 0.937
YOLO_WEIGHT_DECAY = 5e-4


def _seeded_yolo(cls, dtype: torch.dtype, res: int = YOLO_RES, **kwargs):
    model = cls(num_classes=NUM_CLASSES, image_hw=(res, res), dtype=dtype,
                **kwargs)
    return model.init_weights(torch.Generator().manual_seed(SEED))


def build_yolov8(device=None, dtype: torch.dtype = torch.bfloat16) -> YOLOv8:
    """YOLOv8-s, 80 classes, 640x640, in eval mode: weights from ``SEED``
    (flax's default initialisers, the class biases at -4.59) stored in
    ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _seeded_yolo(YOLOv8, dtype).eval().to(device=dev, dtype=dtype,
                                           memory_format=torch.channels_last)


def yolov8_entry(device=None, batch: int = 1
                 ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOv8.predict``
    (top 1000, NMS 0.7, score threshold 0.01, 100 detections): boxes
    (batch, 100, 4) in input pixels, scores, labels (-1 in empty slots),
    ``nms_passes``. The model is ``build_yolov8``'s in bf16; the image is
    ``bench.py``'s, uniform [0, 1) from numpy ``RandomState(0)``, (batch,
    640, 640, 3) f32."""
    return _yolo_serving(build_yolov8(device), batch)


def _yolo_serving(model, batch: int, res: int = YOLO_RES):
    dev = next(model.parameters()).device
    image = np.random.RandomState(0).rand(batch, res, res, 3)
    return model.predict, (torch.from_numpy(image.astype(np.float32)).to(dev),)


def model_loss(model, batch: Dict):
    """``model.loss(batch)``: the loss function of the train steps whose
    model's ``loss`` is the whole loss (the 2D detectors' and the
    segmentors')."""
    return model.loss(batch)


def model_gt_loss(model, batch: Dict):
    """``model.loss_from_gt(batch)``: the loss function of the train steps
    whose model builds its targets on the device from the batch's boxes
    (CenterNet fed by ``coco_batches``, CenterPoint, PointPillars)."""
    return model.loss_from_gt(batch)


def yolov8_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one YOLOv8-s
    train step in place and returns ``(state, metrics)`` (loss, iou_loss,
    cls_loss, dfl_loss, grad_norm, on the device).

    ``configs/yolov8_s_coco.yaml``'s train section: the model seeded with
    ``SEED``, f32 parameters, bf16 compute, channels_last, train mode; SGD
    momentum 0.937, Nesterov, weight decay 5e-4 on ndim > 1 parameters, no
    clip, the lr ``linear_warmup(0.01, 22000, 3.6e6, 0.01)`` of the applied
    steps' count (0 at the first step), inside ``skip_nonfinite_updates``.
    The batch is ``synthetic_detection_batch(batch, (640, 640), 80)``: 2 to
    15 boxes per image in 16 slots."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOv8, torch.bfloat16), dev, batch,
        linear_warmup(YOLO_LR, YOLO_WARMUP, YOLO_TOTAL_STEPS,
                      YOLO_END_FACTOR), YOLO_MOMENTUM)


def _yolo_train_program(model, dev: torch.device, batch: int,
                        schedule: Schedule, momentum: float,
                        nesterov: bool = True, res: int = YOLO_RES,
                        weight_decay: float = YOLO_WEIGHT_DECAY
                        ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """A 2D detector's train step as ``train/train.py --synthetic`` builds
    it: ``model`` on ``dev`` in channels_last and train mode, guarded SGD
    (``momentum``, ``nesterov``, ``weight_decay`` on ndim > 1) under
    ``schedule``, ``synthetic_detection_batch(batch, (res, res), 80)``."""
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    tx = skip_nonfinite_updates(sgd(
        schedule, momentum=momentum, nesterov=nesterov,
        weight_decay=weight_decay))
    state = TrainState.create(model, tx)
    data = synthetic_detection_batch(batch, (res, res), NUM_CLASSES,
                                     seed=SEED)
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return make_train_step(model_loss), (state, data)


# YOLOX-s and YOLOv5-s: configs/yolox_s_coco.yaml, configs/yolov5_s_coco.yaml
# (train: batch 16, Nesterov SGD, decay 5e-4, warmup_cosine(0.01, 2.2e6,
# warm-up) counted from step 0)
YOLO_COSINE_TOTAL_STEPS = 2_200_000
YOLOX_WARMUP = 36700
YOLOX_MOMENTUM = 0.9
YOLOV5_WARMUP = 22000
YOLOV5_MOMENTUM = 0.937
# the bias that calibrate_yolox gives YOLOX's class and objectness convs
YOLOX_SERVE_BIAS = 0.0


def build_yolox(device=None, dtype: torch.dtype = torch.bfloat16) -> YOLOX:
    """YOLOX-s, 80 classes, 640x640, in eval mode: weights from ``SEED``
    (flax's default initialisers, the class and objectness biases at -4.59)
    stored in ``dtype``, which is also the compute dtype; not calibrated
    (``calibrate_yolox``)."""
    dev = resolve_device(device)
    return _seeded_yolo(YOLOX, dtype).eval().to(device=dev, dtype=dtype,
                                            memory_format=torch.channels_last)


@torch.no_grad()
def calibrate_yolox(model: YOLOX) -> YOLOX:
    """Give the seeded YOLOX's requests candidates to keep. Its class and
    objectness convs start at the reference's bias -4.59, so every score
    sigmoid(cls) x sigmoid(obj) is ~1.0e-4, 100 times under ``predict``'s
    0.01 threshold, and a request keeps nothing: its NMS would run on no
    valid box. So the six ``cls_out{i}`` / ``obj_out{i}`` biases are set to
    ``YOLOX_SERVE_BIAS`` (0: both sigmoids near 1/2 before the features
    move them, every score near 0.25), as YOLOv5's seeded head has them:
    the top 1000 candidates all pass the threshold. Returns ``model``,
    changed in place."""
    for i in range(model.head.levels):
        for name in (f"cls_out{i}", f"obj_out{i}"):
            getattr(model.head, name).bias.fill_(YOLOX_SERVE_BIAS)
    return model


def yolox_entry(device=None, batch: int = 1
                ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOX.predict``
    (top 1000, NMS 0.65, score threshold 0.01, 100 detections): boxes
    (batch, 100, 4) in input pixels, scores, labels (-1 in empty slots),
    ``nms_passes``. The model is ``build_yolox``'s in bf16, calibrated
    (``calibrate_yolox``: the seeded model keeps nothing); the image is
    ``yolov8_entry``'s."""
    return _yolo_serving(calibrate_yolox(build_yolox(device)), batch)


def yolox_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                      ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one YOLOX-s
    train step in place and returns ``(state, metrics)`` (loss, iou_loss,
    obj_loss, cls_loss, grad_norm, on the device).

    ``configs/yolox_s_coco.yaml``'s train section: the model seeded with
    ``SEED`` (the reference's initialisers, uncalibrated), f32 parameters,
    bf16 compute, channels_last, train mode; SGD momentum 0.9, Nesterov,
    weight decay 5e-4 on ndim > 1 parameters, no clip, the lr
    ``warmup_cosine(0.01, 2.2e6, 36700)`` of the applied steps' count (0 at
    the first step), inside ``skip_nonfinite_updates``. The batch is
    ``synthetic_detection_batch(batch, (640, 640), 80)``."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOX, torch.bfloat16), dev, batch,
        warmup_cosine(YOLO_LR, YOLO_COSINE_TOTAL_STEPS, YOLOX_WARMUP),
        YOLOX_MOMENTUM)


def build_yolov5(device=None, dtype: torch.dtype = torch.bfloat16
                 ) -> YOLOv5:
    """YOLOv5-s, 80 classes, 640x640, in eval mode: weights from ``SEED``
    (flax's default initialisers: the head's biases at 0) stored in
    ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _seeded_yolo(YOLOv5, dtype).eval().to(
        device=dev, dtype=dtype, memory_format=torch.channels_last)


def yolov5_entry(device=None, batch: int = 1
                 ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOv5.predict``
    (top 1000, NMS 0.45, score threshold 0.05, 100 detections): boxes
    (batch, 100, 4) in input pixels, scores, labels (-1 in empty slots),
    ``nms_passes``. The model is ``build_yolov5``'s in bf16, not
    calibrated (its seeded scores all lie near 0.25); the image is
    ``yolov8_entry``'s."""
    return _yolo_serving(build_yolov5(device), batch)


def yolov5_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one YOLOv5-s
    train step in place and returns ``(state, metrics)`` (loss, box_loss,
    obj_loss, cls_loss, grad_norm, on the device).

    ``configs/yolov5_s_coco.yaml``'s train section: as
    ``yolox_train_entry``, with SGD momentum 0.937 and the lr
    ``warmup_cosine(0.01, 2.2e6, 22000)``."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOv5, torch.bfloat16), dev, batch,
        warmup_cosine(YOLO_LR, YOLO_COSINE_TOTAL_STEPS, YOLOV5_WARMUP),
        YOLOV5_MOMENTUM)


# YOLOv3, YOLOv4, YOLOv7 and SSD-300-MobileNetV2: configs/yolov3_coco.yaml,
# yolov4_coco.yaml, yolov7_coco.yaml and ssd_mbv2_coco.yaml (train: SGD, the
# schedule counted from step 0)
YOLOV3_RES = 416
YOLOV3_LR = 1e-3               # multi_epochs_decay(1e-3, [218, 246], 1833)
YOLOV3_MILESTONES = (218, 246)
YOLOV3_STEPS_PER_EPOCH = 1833
YOLOV3_MOMENTUM = 0.9
YOLOV4_RES = 512
YOLOV4_WIDTH = 1.0
YOLOV4_LR = 1.3e-3             # warmup_cosine(1.3e-3, 2.2e6, 8000)
YOLOV4_WARMUP = 8000
YOLOV4_MOMENTUM = 0.949
YOLOV7_WIDTH = 0.5
YOLOV7_WARMUP = 22000          # warmup_cosine(0.01, 2.2e6, 22000)
YOLOV7_MOMENTUM = 0.937
SSD_RES = 300
SSD_TRAIN_BATCH = 32
SSD_LR = 0.05                  # warmup_cosine(0.05, 400000, 4000)
SSD_TOTAL_STEPS = 400_000
SSD_WARMUP = 4000
SSD_MOMENTUM = 0.9
SSD_WEIGHT_DECAY = 4e-5


def _served(model, dev: torch.device, dtype: torch.dtype):
    return model.eval().to(device=dev, dtype=dtype,
                           memory_format=torch.channels_last)


def build_yolov3(device=None, dtype: torch.dtype = torch.bfloat16
                 ) -> YOLOv3:
    """YOLOv3 (Darknet-53), 80 classes, 416x416, in eval mode: weights from
    ``SEED`` (flax's default initialisers: the heads' biases at 0) stored
    in ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _served(_seeded_yolo(YOLOv3, dtype, YOLOV3_RES), dev, dtype)


def yolov3_entry(device=None, batch: int = 1
                 ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOv3.predict``
    (top 1000, NMS 0.45, score threshold 0.05, 100 detections): boxes
    (batch, 100, 4) in input pixels, scores, labels (-1 in empty slots),
    ``nms_passes``. The model is ``build_yolov3``'s in bf16, not calibrated
    (its seeded scores lie near 0.25); the image uniform [0, 1) from numpy
    ``RandomState(0)``, (batch, 416, 416, 3) f32."""
    return _yolo_serving(build_yolov3(device), batch, YOLOV3_RES)


def yolov3_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one YOLOv3
    train step in place and returns ``(state, metrics)`` (loss, l{i}_obj,
    l{i}_box, grad_norm, on the device).

    ``configs/yolov3_coco.yaml``'s train section: the model seeded with
    ``SEED``, f32 parameters, bf16 compute, channels_last, train mode; SGD
    momentum 0.9 without Nesterov, weight decay 5e-4 on ndim > 1
    parameters, no clip, the lr ``multi_epochs_decay(1e-3, (218, 246),
    1833)`` of the applied steps' count, inside ``skip_nonfinite_updates``.
    The batch is ``synthetic_detection_batch(batch, (416, 416), 80)``."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOv3, torch.bfloat16, YOLOV3_RES), dev, batch,
        multi_epochs_decay(YOLOV3_LR, YOLOV3_MILESTONES,
                           YOLOV3_STEPS_PER_EPOCH),
        YOLOV3_MOMENTUM, nesterov=False, res=YOLOV3_RES)


def build_yolov4(device=None, dtype: torch.dtype = torch.bfloat16
                 ) -> YOLOv4:
    """YOLOv4 (CSPDarknet53, width 1.0), 80 classes, 512x512, in eval mode:
    weights from ``SEED`` (flax's defaults: the heads' biases at 0) stored
    in ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _served(_seeded_yolo(YOLOv4, dtype, YOLOV4_RES,
                                width_mult=YOLOV4_WIDTH), dev, dtype)


def yolov4_entry(device=None, batch: int = 1
                 ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOv4.predict``
    (``AnchorYOLO``'s: top 1000, NMS 0.45, score threshold 0.05, 100
    detections) of ``build_yolov4``'s bf16 model, not calibrated; the image
    as ``yolov3_entry``'s at (batch, 512, 512, 3)."""
    return _yolo_serving(build_yolov4(device), batch, YOLOV4_RES)


def yolov4_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): one YOLOv4 train step in place, ``(state,
    metrics)`` (loss, box_loss, obj_loss, cls_loss, grad_norm).

    ``configs/yolov4_coco.yaml``'s train section: as ``yolov3_train_entry``
    at 512x512 and width 1.0, SGD momentum 0.949 without Nesterov, weight
    decay 5e-4, the lr ``warmup_cosine(1.3e-3, 2.2e6, 8000)`` (0 at the
    first step)."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOv4, torch.bfloat16, YOLOV4_RES,
                     width_mult=YOLOV4_WIDTH), dev, batch,
        warmup_cosine(YOLOV4_LR, YOLO_COSINE_TOTAL_STEPS, YOLOV4_WARMUP),
        YOLOV4_MOMENTUM, nesterov=False, res=YOLOV4_RES)


def build_yolov7(device=None, dtype: torch.dtype = torch.bfloat16
                 ) -> YOLOv7:
    """YOLOv7 (E-ELAN, width 0.5), 80 classes, 640x640, in eval mode:
    weights from ``SEED`` (flax's defaults: the heads' biases at 0) stored
    in ``dtype``, which is also the compute dtype."""
    dev = resolve_device(device)
    return _served(_seeded_yolo(YOLOv7, dtype, width_mult=YOLOV7_WIDTH),
                   dev, dtype)


def yolov7_entry(device=None, batch: int = 1
                 ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``YOLOv7.predict``
    (as ``yolov4_entry``'s) of ``build_yolov7``'s bf16 model, not
    calibrated; the image is ``yolov8_entry``'s."""
    return _yolo_serving(build_yolov7(device), batch)


def yolov7_train_entry(device=None, batch: int = YOLO_TRAIN_BATCH
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): one YOLOv7 train step in place, ``(state,
    metrics)`` (loss, box_loss, obj_loss, cls_loss, grad_norm).

    ``configs/yolov7_coco.yaml``'s train section: as ``yolov5_train_entry``
    (640x640, Nesterov SGD 0.937, weight decay 5e-4, the lr
    ``warmup_cosine(0.01, 2.2e6, 22000)``) with the E-ELAN model at width
    0.5."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_yolo(YOLOv7, torch.bfloat16, width_mult=YOLOV7_WIDTH), dev,
        batch, warmup_cosine(YOLO_LR, YOLO_COSINE_TOTAL_STEPS, YOLOV7_WARMUP),
        YOLOV7_MOMENTUM)


def _seeded_ssd(dtype: torch.dtype) -> SSD:
    model = SSD(num_classes=NUM_CLASSES, image_size=SSD_RES, dtype=dtype)
    return model.init_weights(torch.Generator().manual_seed(SEED))


def build_ssd(device=None, dtype: torch.dtype = torch.bfloat16) -> SSD:
    """SSD-300-MobileNetV2, 80 classes, in eval mode: weights from ``SEED``
    (flax's defaults: every bias at 0) stored in ``dtype``, which is also
    the compute dtype; the anchors stay f32."""
    dev = resolve_device(device)
    return _served(_seeded_ssd(dtype), dev, dtype)


@torch.no_grad()
def calibrate_ssd(model: SSD, image: torch.Tensor) -> SSD:
    """Give the seeded SSD's requests candidates to keep, on this image.
    Its zero-bias class convs over identity BN leave the 81 logits of an
    anchor within a few hundredths of each other, so every class scores
    ~1/81 = 0.012, under ``predict``'s 0.05 threshold, and a request keeps
    nothing. So each map's ``multibox{i}.cls`` conv is scaled to logits of
    std ``CLS_LOGIT_STD`` on ``image`` (its bias stays 0). Returns
    ``model``, changed in place."""
    with torch.inference_mode():
        feats = model.features(image)
        gains = [CLS_LOGIT_STD / float(
            getattr(model, f"multibox{i}")(f)[0].std())
            for i, f in enumerate(feats)]
    for i, g in enumerate(gains):
        getattr(model, f"multibox{i}").cls.weight.mul_(g)
    return model


def ssd_entry(device=None, batch: int = 1
              ) -> Tuple[Callable[..., Dict], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is ``SSD.predict``
    (softmax without the background, top 400, NMS 0.45, score threshold
    0.05, 100 detections) of ``build_ssd``'s bf16 model, calibrated on the
    image (``calibrate_ssd``: the seeded model keeps nothing); the image as
    ``yolov3_entry``'s at (batch, 300, 300, 3)."""
    predict, (image,) = _yolo_serving(build_ssd(device), batch, SSD_RES)
    calibrate_ssd(predict.__self__, image)
    return predict, (image,)


def ssd_train_entry(device=None, batch: int = SSD_TRAIN_BATCH
                    ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): one SSD train step in place, ``(state,
    metrics)`` (loss, cls_loss, reg_loss, grad_norm).

    ``configs/ssd_mbv2_coco.yaml``'s train section: the model seeded with
    ``SEED``, f32 parameters, bf16 compute, channels_last, train mode; SGD
    momentum 0.9 without Nesterov, weight decay 4e-5 on ndim > 1
    parameters, no clip, the lr ``warmup_cosine(0.05, 400000, 4000)`` (0 at
    the first step), inside ``skip_nonfinite_updates``; the batch
    ``synthetic_detection_batch(batch, (300, 300), 80)``."""
    dev = resolve_device(device)
    return _yolo_train_program(
        _seeded_ssd(torch.bfloat16), dev, batch,
        warmup_cosine(SSD_LR, SSD_TOTAL_STEPS, SSD_WARMUP), SSD_MOMENTUM,
        nesterov=False, res=SSD_RES, weight_decay=SSD_WEIGHT_DECAY)


# The segmentors: configs/deeplabv3_r101.yaml, deeplabv3plus_r101.yaml and
# unet.yaml (train: the schedule counted from step 0)
DEEPLAB_CLASSES = 21
DEEPLAB_DEPTH = 101
DEEPLAB_RES = 513
DEEPLAB_TRAIN_BATCH = 16
DEEPLAB_LR = 0.007             # polynomial_decay(0.007, 0, 30000, 0.9)
DEEPLAB_END_LR = 0.0
DEEPLAB_DECAY_STEPS = 30_000
DEEPLAB_POWER = 0.9
DEEPLAB_MOMENTUM = 0.9
DEEPLAB_WEIGHT_DECAY = 4e-5
UNET_CLASSES = 2
UNET_RES = 512
UNET_TRAIN_BATCH = 8
UNET_LR = 3e-4                 # warmup_cosine(3e-4, 40000, 1000)
UNET_TOTAL_STEPS = 40_000
UNET_WARMUP = 1000


def _seeded_seg(cls, dtype: torch.dtype):
    """``cls`` at its config's settings in compute ``dtype``, weights from
    ``SEED`` (flax's default initialisers; He-normal for the ResNet's stem
    and ``BasicBlock`` convs, as the reference's)."""
    if cls is UNet:
        model = UNet(num_classes=UNET_CLASSES, dtype=dtype)
    else:
        model = cls(num_classes=DEEPLAB_CLASSES, depth=DEEPLAB_DEPTH,
                    dtype=dtype)
    return model.init_weights(torch.Generator().manual_seed(SEED))


def build_deeplabv3plus(device=None, dtype: torch.dtype = torch.bfloat16
                        ) -> DeepLabV3Plus:
    """DeepLabV3+ (ResNet-101 at output stride 16, 21 classes) in eval mode:
    weights from ``SEED`` stored in ``dtype``, which is also the compute
    dtype."""
    return _served(_seeded_seg(DeepLabV3Plus, dtype), resolve_device(device),
                   dtype)


def build_deeplabv3(device=None, dtype: torch.dtype = torch.bfloat16
                    ) -> DeepLabV3:
    """DeepLabV3 (``build_deeplabv3plus``'s model without the decoder)."""
    return _served(_seeded_seg(DeepLabV3, dtype), resolve_device(device),
                   dtype)


def build_unet(device=None, dtype: torch.dtype = torch.bfloat16) -> UNet:
    """UNet (widths 64-1024, 2 classes) in eval mode: weights from ``SEED``
    stored in ``dtype``, which is also the compute dtype."""
    return _served(_seeded_seg(UNet, dtype), resolve_device(device), dtype)


def seg_image(batch: int, res: int) -> np.ndarray:
    """The segmentors' request: a ``RandomState(0)`` uniform uint8 image
    (batch, res, res, 3), normalized as ``SegDataset`` normalizes its
    records, f32."""
    rs = np.random.RandomState(0)
    return seg_normalize((rs.rand(batch, res, res, 3) * 255).astype(np.uint8))


def _seg_serving(model, batch: int, res: int):
    dev = next(model.parameters()).device
    return model.predict, (torch.from_numpy(seg_image(batch, res)).to(dev),)


def deeplabv3plus_entry(device=None, batch: int = 1
                        ) -> Tuple[Callable[..., torch.Tensor],
                                   Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``predict_fn(image)`` is
    ``DeepLabV3Plus.predict`` of ``build_deeplabv3plus``'s bf16 model, the
    (batch, 513, 513) class ids; the image is ``seg_image(batch, 513)``."""
    return _seg_serving(build_deeplabv3plus(device), batch, DEEPLAB_RES)


def deeplabv3_entry(device=None, batch: int = 1
                    ) -> Tuple[Callable[..., torch.Tensor],
                               Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``DeepLabV3.predict`` of
    ``build_deeplabv3``'s bf16 model on ``seg_image(batch, 513)``."""
    return _seg_serving(build_deeplabv3(device), batch, DEEPLAB_RES)


def unet_entry(device=None, batch: int = 1
               ) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor]]:
    """(predict_fn, (image,)): ``UNet.predict`` of ``build_unet``'s bf16
    model, the (batch, 512, 512) class ids, on ``seg_image(batch, 512)``."""
    return _seg_serving(build_unet(device), batch, UNET_RES)


def _seg_train_program(model, dev: torch.device, batch: int, res: int,
                       num_classes: int, tx: Recipe
                       ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """A segmentor's train step as ``train/train.py --synthetic`` builds it:
    ``model`` (f32 parameters) on ``dev`` in channels_last and train mode,
    ``tx`` inside the NaN guard, the first batch of
    ``synthetic_seg_batches(batch, (res, res), num_classes)``."""
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    state = TrainState.create(model, skip_nonfinite_updates(tx))
    data = next(synthetic_seg_batches(batch, (res, res), num_classes,
                                      seed=SEED))
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return make_train_step(model_loss), (state, data)


def _deeplab_train_program(cls, device, batch: int):
    return _seg_train_program(
        _seeded_seg(cls, torch.bfloat16), resolve_device(device), batch,
        DEEPLAB_RES, DEEPLAB_CLASSES,
        sgd(polynomial_decay(DEEPLAB_LR, DEEPLAB_END_LR, DEEPLAB_DECAY_STEPS,
                             DEEPLAB_POWER),
            momentum=DEEPLAB_MOMENTUM, weight_decay=DEEPLAB_WEIGHT_DECAY))


def deeplabv3plus_train_entry(device=None, batch: int = DEEPLAB_TRAIN_BATCH
                              ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): ``step_fn(state, batch)`` runs one
    DeepLabV3+ train step in place and returns ``(state, metrics)`` (loss,
    ce, grad_norm, on the device).

    ``configs/deeplabv3plus_r101.yaml``'s train section: the model seeded
    with ``SEED`` (ResNet-101, output stride 16, 21 classes), f32
    parameters, bf16 compute, channels_last, train mode; SGD momentum 0.9
    without Nesterov, weight decay 4e-5 on ndim > 1 parameters, no clip,
    the lr ``polynomial_decay(0.007, 0, 30000, 0.9)`` of the applied steps'
    count (0.007 at the first step), inside ``skip_nonfinite_updates``. The
    batch is ``synthetic_seg_batches(batch, (513, 513), 21)``'s first."""
    return _deeplab_train_program(DeepLabV3Plus, device, batch)


def deeplabv3_train_entry(device=None, batch: int = DEEPLAB_TRAIN_BATCH
                          ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): one DeepLabV3 train step in place,
    ``(state, metrics)`` (loss, ce, grad_norm); ``configs/
    deeplabv3_r101.yaml``'s train section, as
    ``deeplabv3plus_train_entry``'s."""
    return _deeplab_train_program(DeepLabV3, device, batch)


def unet_train_entry(device=None, batch: int = UNET_TRAIN_BATCH
                     ) -> Tuple[Callable, Tuple[TrainState, Dict]]:
    """(step_fn, (state, batch)): one UNet train step in place, ``(state,
    metrics)`` (loss, ce, grad_norm).

    ``configs/unet.yaml``'s train section: the model seeded with ``SEED``
    (widths 64-1024, 2 classes), f32 parameters, bf16 compute,
    channels_last, train mode; Adam without decay, no clip, the lr
    ``warmup_cosine(3e-4, 40000, 1000)`` of the applied steps' count (0 at
    the first step), inside ``skip_nonfinite_updates``; the batch
    ``synthetic_seg_batches(batch, (512, 512), 2)``'s first."""
    return _seg_train_program(
        _seeded_seg(UNet, torch.bfloat16), resolve_device(device), batch,
        UNET_RES, UNET_CLASSES,
        adam(warmup_cosine(UNET_LR, UNET_TOTAL_STEPS, UNET_WARMUP)))
