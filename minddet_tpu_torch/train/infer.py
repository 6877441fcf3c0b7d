"""Streaming inference: a directory of point clouds -> detections
(counterpart of ``minddet_tpu/train/infer.py``)::

    python -m minddet_tpu_torch.train.infer \\
        --config configs/pointpillars_car_kitti.yaml --input VELODYNE_DIR \\
        --output OUT_DIR [--checkpoint WORKDIR/ckpt/STEP] [--visualize] \\
        [--max-frames N] [--device cpu]

Each ``.bin`` cloud (f32 rows of 4 features for PointPillars, 5 for
CenterPoint) goes through the model's padded serving program,
``predict_from_points_padded`` (``voxelize`` into the model's padded voxels,
then ``predict``: on the GPU the rotated NMS launches K4), and its
detections are written as ``OUT_DIR/<frame>.json`` (``frame``, ``boxes``,
``scores``, ``labels``), with a bird's-eye view ``<frame>.png`` under
``--visualize`` (cv2, not on the GPU host). The p50 latency of the frames
after the first is logged. Image configs exit, as the reference's CLI does.

Three faults of the reference's CLI are not copied (``ROADMAP.md`` §3):
- it reads ``cfg.anchors``, which no config has, so both PointPillars
  configs raise ``AttributeError``: here the anchors are the model's own
  (``PointPillars.anchors``, inside ``predict_from_points_padded``);
- it does not count ``CenterPointTwoStage`` as lidar and exits: here it is
  lidar and runs the branch the reference's would (the padded voxels, then
  the first stage's ``predict``);
- it takes ``max_voxels`` from a missing ``voxelizer:`` section (16000 where
  the models say 12000 to 32000) and cuts every cloud to 60,000 points:
  here the voxels and points per voxel are the model's and the cloud's
  capacity is the config's ``data.max_points``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from minddet_tpu_torch.core.checkpoint import load_pytree
from minddet_tpu_torch.core.config import Config
from minddet_tpu_torch.core.metrics import logger
from minddet_tpu_torch.core.registry import DETECTORS
from minddet_tpu_torch.entry import resolve_device
from minddet_tpu_torch.models import zoo  # noqa: F401  (the registry)

LIDAR_MODELS = ("PointPillars", "CenterPoint", "CenterPointTwoStage")
VISUAL_SCORE = 0.3  # boxes drawn in the bird's-eye view score above this


def point_features(model_type: str) -> int:
    """Features per point of a ``.bin`` cloud: x, y, z, intensity for
    PointPillars (KITTI), and the sweep time or elongation for CenterPoint
    (nuScenes, Waymo)."""
    return 4 if model_type == "PointPillars" else 5


def build_served(cfg: Config, checkpoint=None, device=None):
    """The config's detector (``DETECTORS``) in eval mode on ``device``:
    weights drawn from a generator seeded 0, then the ``model`` state dict
    of ``checkpoint`` (a step directory of ``core/checkpoint.py``) where
    given."""
    dev = resolve_device(device)
    model = DETECTORS.build(dict(cfg.model)).init_weights(
        torch.Generator().manual_seed(0))
    if checkpoint:
        model.load_state_dict(load_pytree(checkpoint)["model"])
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def main(argv=None) -> Dict:
    """The streaming CLI; returns ``{"frames": n, "p50_ms": ...,
    "seconds": [per frame]}`` (p50 None below two frames)."""
    p = argparse.ArgumentParser(description="minddet_tpu_torch streaming "
                                            "inference")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--input", required=True, help="dir of .bin clouds")
    p.add_argument("--output", default="detections")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    model_type = cfg.model.type
    if model_type not in LIDAR_MODELS:
        raise SystemExit("image-stream inference: use train.evaluate for now")
    model = build_served(cfg, args.checkpoint, args.device)
    dev = next(model.parameters()).device
    os.makedirs(args.output, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.input, "*")))
    if args.max_frames:
        files = files[: args.max_frames]
    logger.info("%d frames from %s", len(files), args.input)

    n_feat = point_features(model_type)
    capacity = int(cfg.data.max_points)
    pts = torch.zeros(1, capacity, n_feat)
    seconds = []
    for fi, f in enumerate(files):
        raw = np.fromfile(f, np.float32).reshape(-1, n_feat)[:capacity]
        pts[0, : len(raw)] = torch.from_numpy(raw)
        mask = torch.arange(capacity)[None] < len(raw)
        t0 = time.perf_counter()
        out = model.predict_from_points_padded(pts.to(dev), mask.to(dev))
        boxes = out["boxes"][0].cpu().numpy()
        scores = out["scores"][0].cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        dets = {"frame": os.path.basename(f), "boxes": boxes.tolist(),
                "scores": scores.tolist(),
                "labels": out["labels"][0].cpu().numpy().tolist()}
        with open(os.path.join(args.output, f"{fi:06d}.json"), "w") as g:
            g.write(json.dumps(dets))
        if args.visualize:
            import cv2

            from minddet_tpu_torch.utils.visual import draw_bev

            img = draw_bev(raw, boxes[scores > VISUAL_SCORE],
                           tuple(cfg.model.pc_range))
            cv2.imwrite(os.path.join(args.output, f"{fi:06d}.png"), img)
    p50 = float(np.median(seconds[1:]) * 1e3) if len(seconds) > 1 else None
    logger.info("done: %d frames, p50 latency %s ms", len(files),
                "n/a" if p50 is None else f"{p50:.1f}")
    return {"frames": len(files), "p50_ms": p50, "seconds": seconds}


if __name__ == "__main__":
    main()
