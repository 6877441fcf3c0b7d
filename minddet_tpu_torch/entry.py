"""The serving program of the flagship model, ready to call.

Counterpart of ``__graft_entry__.entry()`` for ``CenterNet.predict``:
CenterNet-ResNet18-DCNv2, 80 classes, 512x512, bf16, top-100 decode.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from minddet_tpu_torch.models.detectors.centernet import CenterNet

RES = 512
NUM_CLASSES = 80
SEED = 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one it raises; the port never
    carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def build_model(device=None, dtype: torch.dtype = torch.bfloat16
                ) -> CenterNet:
    """The flagship CenterNet in eval mode, weights from ``SEED``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(SEED)
    model = CenterNet(num_classes=NUM_CLASSES, depth=18, dcn=True)
    model.init_weights(gen)
    return model.eval().to(device=dev, dtype=dtype,
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
