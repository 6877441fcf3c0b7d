"""YOLOv7: the E-ELAN backbone, PAN and the sigmoid² anchor head
(counterpart of ``minddet_tpu/models/detectors/yolov7.py``:
``YOLOV7_ANCHORS`` and ``YOLOv7``, the deploy-form topology of the
reference). Everything but the backbone and the anchors is
``AnchorYOLO``'s; ``PAN`` takes ``ELANNet``'s own widths (512, 1024, 1024
scaled), not the neck's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from minddet_tpu_torch.models.backbones.elan import ELANNet
from minddet_tpu_torch.models.detectors.yolov5 import AnchorYOLO

# v7 anchors (640 input), (w, h) pixels, stride 8 / 16 / 32
YOLOV7_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)


class YOLOv7(AnchorYOLO):
    """``AnchorYOLO`` with ``ELANNet(width_mult)``, the "sigmoid2" decode
    and ``YOLOV7_ANCHORS``; width 0.5 by default, as the config's."""

    def __init__(self, num_classes: int = 80,
                 image_hw: Tuple[int, int] = (640, 640),
                 width_mult: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, image_hw, YOLOV7_ANCHORS, "sigmoid2",
                         width_mult, dtype=dtype)

    def make_backbone(self) -> nn.Module:
        return ELANNet(self.width_mult)
