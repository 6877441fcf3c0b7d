"""YOLOv4: CSPDarknet53 (Mish), PAN and the exp-decode anchor head
(counterpart of ``minddet_tpu/models/detectors/yolov4.py``:
``YOLOV4_ANCHORS`` and ``YOLOv4``). Everything but the backbone, the
anchors and the decode flavour is ``AnchorYOLO``'s.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.backbones.csp_darknet import CSPDarknet53
from minddet_tpu_torch.models.detectors.yolov5 import AnchorYOLO

# the v4 paper's anchors (512 input), (w, h) pixels, stride 8 / 16 / 32
YOLOV4_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)


class YOLOv4(AnchorYOLO):
    """``AnchorYOLO`` with ``CSPDarknet53(width_mult)``, the "exp" decode
    and ``YOLOV4_ANCHORS``; width 0.5 by default, as the reference's
    (``configs/yolov4_coco.yaml`` takes 1.0)."""

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (640, 640),
                 width_mult: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, image_hw, YOLOV4_ANCHORS, "exp",
                         width_mult, dtype=dtype)

    def make_backbone(self) -> nn.Module:
        return CSPDarknet53(self.width_mult)
