"""The training CLI (counterpart of ``minddet_tpu/train/train.py``): one
registry-driven launcher for every config::

    python -m minddet_tpu_torch.train.train --config configs/centernet_r18_coco.yaml \\
        [--options model.depth=50 train.batch_size=8] [--synthetic] \\
        [--steps N] [--workdir DIR] [--resume] [--device cpu]

The config's model is built by ``DETECTORS``, its weights drawn from a
``torch.Generator`` seeded 0 (``create_train_state``); the optimizer and
schedule come from its train section (``build_optimizer``,
``build_schedule``: the NaN guard by default); batches from the synthetic
generators or the config's data pipeline (``train/synthetic.py``);
``Trainer`` writes ``<workdir>/metrics.jsonl`` and checkpoints under
``<workdir>/ckpt``. It runs on the GPU unless ``--device`` says otherwise,
and on one device: a config with ``train.fsdp`` > 1 raises.
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import Any, Callable, Dict, Iterator

import torch

from minddet_tpu_torch.core.checkpoint import CheckpointManager
from minddet_tpu_torch.core.config import Config
from minddet_tpu_torch.core.lr_schedules import build_schedule
from minddet_tpu_torch.core.metrics import (MetricWriter, logger,
                                            profiler_trace)
from minddet_tpu_torch.core.optim import build_optimizer
from minddet_tpu_torch.core.registry import DETECTORS
from minddet_tpu_torch.entry import resolve_device
from minddet_tpu_torch.models import zoo  # noqa: F401  (the registry)
from minddet_tpu_torch.train.loop import (Trainer, create_train_state,
                                          make_train_step)
from minddet_tpu_torch.train.synthetic import (coco_batches, kitti_batches,
                                               nuscenes_batches, seg_batches,
                                               synthetic_detection_batches,
                                               synthetic_points_batches,
                                               synthetic_seg_batches,
                                               waymo_batches)

INIT_SEED = 0   # the weights' generator (the reference's PRNGKey(0))
STEP_SEED = 17  # the per-step draws' base (the reference's PRNGKey(17))


def loss_method_for(model) -> Callable:
    """Uniform loss entry: ``loss_from_gt`` (targets made on the device
    from the batch's boxes) where the model has one, else ``loss``."""
    return getattr(model, "loss_from_gt", None) or model.loss


def step_generator(step: int, device) -> torch.Generator:
    """The draws of the batch of draw index ``step``: a generator on
    ``device`` seeded from STEP_SEED and ``step`` (the reference's
    ``fold_in(PRNGKey(17), step)``)."""
    return torch.Generator(device=device).manual_seed(
        (STEP_SEED << 32) + int(step))


def train_loss(model) -> Callable:
    """The train step's loss function ``(model, batch) -> (total, parts)``:
    ``loss_method_for(model)`` on the batch without its ``step``; a model
    that samples (``sampling_draws``: the R-CNNs) draws from
    ``step_generator(step)``."""
    method_name = loss_method_for(model).__name__

    def loss(model, batch: Dict) -> Any:
        batch = dict(batch)
        step = batch.pop("step", 0)
        method = getattr(model, method_name)
        if hasattr(model, "sampling_draws"):
            gt = batch["gt_boxes"]
            draws = model.sampling_draws(
                gt.shape[0], gt.shape[1],
                step_generator(step, gt.device))
            return method(batch, draws)
        return method(batch)

    return loss


def train_batches(cfg, model, batch_size: int, synthetic: bool,
                  device) -> Iterator[Dict]:
    """The batches of a config, as the reference's ``main`` picks them:
    the synthetic generators with ``synthetic`` or without a data section
    (points for kitti / nuscenes / waymo data, 9-wide boxes and the
    tasks' classes for the last two; segmentation masks for seg data, a
    UNet or a DeepLabV3Plus; else boxes, with GT bitmaps for a mask
    model), else the data type's pipeline."""
    mcfg, tcfg = cfg.model, cfg.train
    image_hw = tuple(tcfg.get("image_hw", (512, 512)))
    num_classes = int(mcfg.get("num_classes", 80))
    data_type = cfg.data.get("type", "coco") if "data" in cfg else "coco"
    if synthetic or "data" not in cfg:
        if data_type in ("kitti", "nuscenes", "waymo"):
            pc_range = tuple(mcfg.get("pc_range",
                                      (0, -39.68, -3, 69.12, 39.68, 1)))
            is_cp = data_type in ("nuscenes", "waymo")
            if is_cp:
                num_classes = int(sum(mcfg.get("task_num_classes", (10,))))
            default_features = 5 if is_cp else 4
            features = int(cfg.data.get("num_features", default_features)) \
                if "data" in cfg else default_features
            return synthetic_points_batches(
                batch_size, pc_range, num_classes=num_classes,
                num_features=features, box_dim=9 if is_cp else 7)
        if data_type == "seg" or mcfg.get("type") in ("UNet",
                                                      "DeepLabV3Plus"):
            return synthetic_seg_batches(batch_size, image_hw, num_classes)
        return synthetic_detection_batches(
            batch_size, image_hw, num_classes,
            with_masks=bool(getattr(model, "with_mask", False)),
            mask_stride=int(getattr(model, "mask_stride", 4)))
    if data_type == "kitti":
        return kitti_batches(cfg, batch_size)
    if data_type == "nuscenes":
        return nuscenes_batches(cfg, batch_size)
    if data_type == "waymo":
        return waymo_batches(cfg, batch_size)
    if data_type == "seg":
        return seg_batches(cfg, batch_size)
    return coco_batches(cfg, batch_size, image_hw,
                        aug=tcfg.get("aug", "affine"), device=device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="minddet_tpu_torch trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke runs / perf)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the workdir")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace of the run to "
                        "<workdir>/trace")
    p.add_argument("--data-url", default=None,
                   help="stage this (gs://, s3://, obs:// or local) "
                        "directory into <workdir>/data before training and "
                        "point data.records at it")
    p.add_argument("--train-url", default=None,
                   help="mirror the workdir (checkpoints, metrics) to this "
                        "destination when training ends")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Train a config (``parse_args``); returns the final ``TrainState``.

    The first batch drawn is the sample the state is made from, as in the
    reference, so training starts on the second. With ``--resume`` the
    latest checkpoint in ``<workdir>/ckpt`` is restored and the batches
    the checkpoint's steps consumed are drawn and skipped, so a resumed
    run sees the batches a straight run would; ``--steps`` counts the
    steps of this invocation."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config).merge_from_options(args.options)
    if args.data_url:
        from minddet_tpu_torch.utils.cloud import sync_dir

        local_data = sync_dir(args.data_url,
                              os.path.join(args.workdir, "data"))
        if "data" in cfg and cfg.data.get("records"):
            cfg.data["records"] = os.path.join(
                local_data, os.path.basename(str(cfg.data["records"])))
        logger.info("cloud-train: staged %s -> %s", args.data_url,
                    local_data)
    model = DETECTORS.build(dict(cfg.model))
    tcfg = cfg.train
    if int(tcfg.get("fsdp", 1)) > 1:
        raise NotImplementedError(
            "train.fsdp > 1 needs the DDP / FSDP port (ROADMAP.md §1.5 "
            "item 7); the port trains on one device")
    steps = args.steps or int(tcfg.get("total_steps", 1000))
    tx = build_optimizer(dict(tcfg.optimizer),
                         build_schedule(dict(tcfg.lr_schedule)))
    batch_size = int(tcfg.get("batch_size", 8))
    batches = train_batches(cfg, model, batch_size, args.synthetic, dev)
    sample = next(batches)
    state = create_train_state(model, torch.Generator().manual_seed(
        INIT_SEED), sample, tx, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info("model %s: %.2fM params", cfg.model.get("type"),
                n_params / 1e6)
    save_every = int(tcfg.get("save_every", 1000))
    ckpt = CheckpointManager(
        os.path.join(args.workdir, "ckpt"),
        keep_max=int(tcfg.get("keep_checkpoint_max", 5)),
        save_interval_steps=save_every)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
        start_step = state.step
        batches = itertools.islice(batches, start_step, None)
        logger.info("resumed from step %d", start_step)
    trainer = Trainer(state, make_train_step(train_loss(state.model)),
                      metric_writer=MetricWriter(args.workdir),
                      checkpoint_manager=ckpt,
                      log_every=int(tcfg.get("log_every", 50)),
                      save_every=save_every)
    with profiler_trace(os.path.join(args.workdir, "trace")
                        if args.profile else None):
        state = trainer.fit(batches, num_steps=steps, batch_size=batch_size,
                            start_step=start_step)
    ckpt.close()
    logger.info("done: %d steps", steps)
    if args.train_url:
        from minddet_tpu_torch.utils.cloud import upload_dir

        upload_dir(args.workdir, args.train_url)
        logger.info("cloud-train: uploaded %s -> %s", args.workdir,
                    args.train_url)
    return state


if __name__ == "__main__":
    main()
