"""The port's components in the shared registries, under the reference's
names (its ``register_module`` sites): detectors, backbones, necks, heads,
readers, the second stage and ROI heads, losses and datasets.

A config's model section names a detector by ``type`` and sets the
reference module's fields. ``DETECTORS.build`` takes every field the
reference's detector has: a field the port's class takes is passed on
(lists as tuples, a dtype by name as the torch dtype); a field the port
keeps as a constant (``FIXED``) may only restate the reference's default;
a field that only picks a TPU layout or compile strategy of the same
function (``IGNORED``) is accepted and dropped. Any other key raises
ValueError. The other registries hold the port's classes and functions
themselves: the port's modules are built eagerly, so a neck or head also
needs its input width, which the reference infers.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Mapping, Sequence

import torch

from minddet_tpu_torch.core.registry import (BACKBONES, DATASETS, DETECTORS,
                                             HEADS, LOSSES, NECKS, READERS,
                                             ROI_HEAD, SECOND_STAGE)
from minddet_tpu_torch.data.coco import CocoDetection
from minddet_tpu_torch.data.kitti import KittiDetection
from minddet_tpu_torch.data.nuscenes import NuScenesDetection
from minddet_tpu_torch.data.seg import SegDataset
from minddet_tpu_torch.data.waymo import WaymoDetection
from minddet_tpu_torch.models import losses
from minddet_tpu_torch.models.backbones.csp_darknet import (CSPDarknet,
                                                            CSPDarknet53)
from minddet_tpu_torch.models.backbones.elan import ELANNet
from minddet_tpu_torch.models.backbones.mobilenet import MobileNetV2
from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.models.detectors.faster_rcnn import (FasterRCNN,
                                                            MaskRCNN)
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.models.detectors.ssd import (ANCHORS_PER_LOC,
                                                    EXTRA_CHANNELS, SSD)
from minddet_tpu_torch.models.detectors.yolov3 import IGNORE_IOU, YOLOv3
from minddet_tpu_torch.models.detectors.yolov4 import (YOLOV4_ANCHORS,
                                                       YOLOv4)
from minddet_tpu_torch.models.detectors.yolov5 import RATIO_THRESH, YOLOv5
from minddet_tpu_torch.models.detectors.yolov7 import (YOLOV7_ANCHORS,
                                                       YOLOv7)
from minddet_tpu_torch.models.detectors.yolov8 import YOLOv8
from minddet_tpu_torch.models.detectors.yolox import STRIDES, YOLOX
from minddet_tpu_torch.models.heads.center_head import CenterHead
from minddet_tpu_torch.models.heads.centernet_head import CenterNetHead
from minddet_tpu_torch.models.heads.roi_head import BoxHead, MaskHead
from minddet_tpu_torch.models.heads.rpn_head import RPNHead
from minddet_tpu_torch.models.heads.second_stage import (BEVFeatureExtractor,
                                                         BEVRefineHead)
from minddet_tpu_torch.models.necks.ct_deconv import CenterNetDeconvNeck
from minddet_tpu_torch.models.necks.fpn import FPN
from minddet_tpu_torch.models.necks.pan import PAN, C2fPAN
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.models.readers.pillar_encoder import (
    PillarFeatureNet, PointPillarsScatter)
from minddet_tpu_torch.models.segmentors import (ASPP_FEATURES,
                                                 OUTPUT_STRIDE, DeepLabV3,
                                                 DeepLabV3Plus, UNet)

# the lidar RPN's TPU layouts and compile strategies: the same function
LIDAR_LAYOUT_KEYS = ("rpn_space_to_depth", "rpn_scan_inner",
                     "rpn_scan_min_layers")
# layouts the port does not build: the stacked RPN checkpoint tree and the
# BEV spatial sharding (the parallel port)
LIDAR_FIXED = {"rpn_stacked_params": False, "bev_shard_spec": None}
CENTERPOINT_FIXED = dict(
    LIDAR_FIXED, loc_weight=0.25, max_objs=500,
    code_weights=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0))
YOLO_FIXED = {"ratio_thresh": RATIO_THRESH}
# name -> (class, FIXED, IGNORED)
DETECTOR_SPECS = {
    "CenterNet": (CenterNet, {}, ()),
    "CenterPoint": (CenterPoint, CENTERPOINT_FIXED,
                    LIDAR_LAYOUT_KEYS + ("scatter_extra_channel",)),
    "CenterPointTwoStage": (
        CenterPointTwoStage,
        dict(CENTERPOINT_FIXED, stage2_score_weight=1.0,
             stage2_box_weight=1.0),
        LIDAR_LAYOUT_KEYS + ("scatter_extra_channel",)),
    "PointPillars": (PointPillars, LIDAR_FIXED, LIDAR_LAYOUT_KEYS),
    "FasterRCNN": (FasterRCNN, {}, ()),
    "MaskRCNN": (MaskRCNN, {}, ()),
    "SSD": (SSD, {"extra_channels": EXTRA_CHANNELS,
                  "num_anchors_per_loc": ANCHORS_PER_LOC}, ()),
    "YOLOv3": (YOLOv3, {"ignore_iou": IGNORE_IOU}, ()),
    "YOLOv4": (YOLOv4, dict(YOLO_FIXED, anchors=YOLOV4_ANCHORS,
                            decode_flavor="exp", depth_mult=0.33), ()),
    "YOLOv5": (YOLOv5, YOLO_FIXED, ()),
    "YOLOv7": (YOLOv7, dict(YOLO_FIXED, anchors=YOLOV7_ANCHORS,
                            decode_flavor="sigmoid2", depth_mult=0.33), ()),
    "YOLOv8": (YOLOv8, {}, ()),
    "YOLOX": (YOLOX, {"strides": STRIDES}, ()),
    "DeepLabV3Plus": (DeepLabV3Plus, {"aspp_features": ASPP_FEATURES,
                                      "output_stride": OUTPUT_STRIDE}, ()),
    "DeepLabV3": (DeepLabV3, {"aspp_features": ASPP_FEATURES,
                              "output_stride": OUTPUT_STRIDE,
                              "use_decoder": False}, ()),
    "UNet": (UNet, {}, ()),
}


def _tup(v):
    return tuple(_tup(x) for x in v) if isinstance(v, (list, tuple)) else v


def init_keys(cls) -> Sequence[str]:
    """The keyword arguments of ``cls``'s constructor, through its bases'
    where it passes ``**kwargs`` on."""
    keys = []
    for klass in cls.__mro__:
        if "__init__" not in vars(klass):
            continue
        params = inspect.signature(vars(klass)["__init__"]).parameters
        keys += [k for k, p in params.items() if k != "self" and p.kind in (
            p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return keys


def model_kwargs(mcfg: Mapping, keys: Sequence[str], fixed: Mapping,
                 ignored: Sequence[str], name: str) -> Dict:
    """The arguments of a model section for a class taking ``keys`` (lists
    as tuples, a ``dtype`` by name as the torch dtype): a ``fixed`` key set
    to another value than its own, or a key in none of the three, raises
    ValueError naming it."""
    mcfg = {k: v for k, v in mcfg.items() if k != "type"}
    unknown = set(mcfg) - set(keys) - set(fixed) - set(ignored)
    wrong = {k: mcfg[k] for k in fixed
             if k in mcfg and _tup(mcfg[k]) != _tup(fixed[k])}
    if unknown or wrong:
        raise ValueError(f"{name} config keys not ported: "
                         f"{sorted(unknown) or wrong}")
    out = {k: _tup(v) for k, v in mcfg.items()
           if k in keys and k not in fixed}
    if isinstance(out.get("dtype"), str):
        out["dtype"] = getattr(torch, out["dtype"])
    return out


def _detector_builder(name: str, cls, fixed: Mapping,
                      ignored: Sequence[str]) -> Callable:
    keys = init_keys(cls)

    def build(**mcfg):
        return cls(**model_kwargs(mcfg, keys, fixed, ignored, name))

    build.__name__ = build.__qualname__ = name
    build.__doc__ = (f"``{cls.__name__}`` from a model section (the "
                     f"reference's ``DETECTORS['{name}']``; "
                     f"``model_kwargs``).")
    return build


def detector_kwargs(mcfg: Mapping) -> Dict:
    """The constructor arguments of a model section's ``type``
    (``model_kwargs`` with its spec)."""
    cls, fixed, ignored = DETECTOR_SPECS[mcfg["type"]]
    return model_kwargs(mcfg, init_keys(cls), fixed, ignored, mcfg["type"])


for _name, (_cls, _fixed, _ignored) in DETECTOR_SPECS.items():
    DETECTORS.register_module(module=_detector_builder(_name, _cls, _fixed,
                                                       _ignored))
for _registry, _members in (
        (BACKBONES, (MobileNetV2, CSPDarknet, CSPDarknet53, ELANNet,
                     ResNet)),
        (NECKS, (FPN, SECONDRPN, CenterNetDeconvNeck, PAN, C2fPAN)),
        (HEADS, (CenterNetHead, CenterHead, RPNHead)),
        (READERS, (PillarFeatureNet, PointPillarsScatter)),
        (SECOND_STAGE, (BEVFeatureExtractor,)),
        (ROI_HEAD, (BEVRefineHead, BoxHead, MaskHead)),
        (LOSSES, (losses.centernet_focal_loss, losses.gather_reg_loss,
                  losses.fast_focal_loss, losses.sigmoid_focal_loss,
                  losses.weighted_smooth_l1, losses.weighted_softmax_ce,
                  losses.gather_reg_loss_per_channel)),
        (DATASETS, (KittiDetection, WaymoDetection, CocoDetection,
                    NuScenesDetection, SegDataset))):
    for _member in _members:
        _registry.register_module(module=_member)
