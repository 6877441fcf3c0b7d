"""Losses of the first SGD steps of Faster R-CNN at the config's lr, on the
CPU: the JAX reference from its own ``init`` and the port from the same
seeded weights as its train entries before and after
``seed_rcnn_for_training``.

    JAX_PLATFORMS=cpu python3 scripts/rcnn_lr_divergence.py [--steps 8]

ResNet-50-FPN, 80 classes, cut to 128 x 128, batch 2, RPN top 200 per
level and 128 after its NMS, 64 ROI samples; SGD lr 0.01, momentum 0.9,
weight decay 1e-4, no clip (``configs/faster_rcnn_r50_coco.yaml``); f32;
``train/train.py``'s synthetic batch (seed 0). Prints one line per model
and step: the loss and the global norm of the gradients. Takes a few
minutes. It needs JAX for the reference, as the tests do; the port's
package imports none.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RES, BATCH, CLASSES = 128, 2, 80
MODEL = dict(num_classes=CLASSES, depth=50, image_hw=(RES, RES),
             rpn_pre_nms=200, rpn_post_nms=128, roi_samples=64)
LR, MOMENTUM, WEIGHT_DECAY = 0.01, 0.9, 1e-4


def reference(steps: int):
    import jax
    import jax.numpy as jnp

    from minddet_tpu.core.optim import sgd
    from minddet_tpu.models.detectors.faster_rcnn import FasterRCNN
    from minddet_tpu.train.loop import TrainState, make_train_step
    from minddet_tpu.train.train import synthetic_detection_batches

    model = FasterRCNN(**MODEL)
    batch = next(synthetic_detection_batches(BATCH, (RES, RES), CLASSES))
    batch.pop("step")
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)}, batch,
                           method=model.loss)

    def loss_apply(v, b, train=True):
        return model.apply(v, b, train=train, method=model.loss,
                           mutable=["batch_stats"],
                           rngs={"sampling": jax.random.PRNGKey(17)})

    state = TrainState.create(variables["params"], variables["batch_stats"],
                              sgd(LR, momentum=MOMENTUM,
                                  weight_decay=WEIGHT_DECAY))
    step = make_train_step(loss_apply, donate=False)
    for i in range(steps):
        state, m = step(state, batch)
        yield i, float(m["loss"]), float(m["grad_norm"])


def port(steps: int, seeded: bool):
    import torch

    from minddet_tpu_torch.core.optim import sgd
    from minddet_tpu_torch.entry import (SEED, rcnn_loss,
                                         seed_rcnn_for_training)
    from minddet_tpu_torch.models.detectors.faster_rcnn import FasterRCNN
    from minddet_tpu_torch.train.loop import TrainState, make_train_step
    from minddet_tpu_torch.train.synthetic import synthetic_detection_batch

    model = FasterRCNN(**MODEL).init_weights(
        torch.Generator().manual_seed(SEED))
    if seeded:
        seed_rcnn_for_training(model,
                               torch.Generator().manual_seed(SEED + 2))
    model = model.to(memory_format=torch.channels_last).train()
    batch = {k: torch.from_numpy(v) for k, v in synthetic_detection_batch(
        BATCH, (RES, RES), CLASSES).items()}
    batch["generator"] = torch.Generator().manual_seed(SEED)
    state = TrainState.create(model, sgd(LR, momentum=MOMENTUM,
                                         weight_decay=WEIGHT_DECAY))
    step = make_train_step(rcnn_loss)
    for i in range(steps):
        state, m = step(state, batch)
        yield i, float(m["loss"]), float(m["grad_norm"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    runs = (("reference, flax init", reference(args.steps)),
            ("port, flax-default seed", port(args.steps, False)),
            ("port, seed_rcnn_for_training", port(args.steps, True)))
    for label, steps in runs:
        for i, loss, norm in steps:
            print(f"{label}: step {i + 1} loss {loss:.6g} grad_norm "
                  f"{norm:.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
