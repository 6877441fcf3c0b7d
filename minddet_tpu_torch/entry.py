"""The flagship programs, ready to call.

``entry()`` is the serving program (counterpart of ``CenterNet.predict`` as
the reference jits it): CenterNet-ResNet18-DCNv2, 80 classes, 512x512,
bf16, top-100 decode. ``train_entry()`` is the train step that
``__graft_entry__.entry()`` and ``bench.py:headline_setup`` build: the same
model with f32 parameters and bf16 compute, targets made on the device from
synthetic boxes, focal + gathered-L1 loss, AdamW(5e-4) with clip-by-global-
norm 35 and the BN running-stat update.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from minddet_tpu_torch.core.optim import adamw
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.ops.targets import centernet_targets_batch
from minddet_tpu_torch.train.loop import TrainState, make_train_step

RES = 512
NUM_CLASSES = 80
SEED = 0
OBJECTS = 128         # box slots per image (bench.py: o = 128)
VALID_OBJECTS = 8     # valid boxes per image (bench.py: n = 8)


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
