"""``train/infer.py`` (the streaming CLI) on the CPU, against the reference.

The reference's CLI has three faults (``ROADMAP.md`` §3), pinned here on
the repo's configs without running a model:
- on a PointPillars config it reads ``cfg.anchors``, which no config has:
  ``AttributeError``;
- on ``configs/centerpoint_pp_nusc_two_stage.yaml`` it exits with "image-stream
  inference": ``CenterPointTwoStage`` is not counted as lidar;
- on ``configs/centerpoint_pp_nusc.yaml`` it voxelizes into 16000 voxels
  where the model says 30000, and cuts the cloud to 60,000 points where the
  config's ``data.max_points`` is 120,000 (its voxelizer is stopped at its
  first call and its arguments read).

The port's CLI is run with ``--device cpu`` on tiny configs of both model
families at 80 x 80 grids (PointPillars from its own anchors, and
``CenterPointTwoStage``, whose served program is the padded first stage),
with ``max_voxels`` 400 and a capacity of 3000 points against clouds of
3500, whose occupied pillars overflow the voxels and some pillars the point
cap; the weights are numpy-random flax variables carried over by the
converters into a checkpoint. Each frame's JSON equals the reference's
``voxelize_batch`` at the model's own ``max_voxels`` and points per voxel on
the cloud cut to the capacity, then ``predict`` (PointPillars with the
anchor-area mask of its dense branch, as the port's
``predict_from_points_padded``): labels exactly, scores within 1e-5, boxes
within 1e-4 (the f32 network summed in another order than XLA's).
"""

import glob
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_pointpillars import random_variables

from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCenterPointTwoStage)
from minddet_tpu.models.detectors.pointpillars import PointPillars as JPP
from minddet_tpu.ops.anchors import anchors_bev_area_mask
from minddet_tpu.ops.box import rbbox_to_near_bbox
from minddet_tpu.ops.voxelize import voxelize_batch
from minddet_tpu.train import infer as jinfer
from minddet_tpu_torch.core.checkpoint import save_pytree
from minddet_tpu_torch.models.detectors.centerpoint import CenterPointTwoStage
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.train import infer as tinfer
from minddet_tpu_torch.utils.convert import (centerpoint_from_flax,
                                             pointpillars_from_flax)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
CAPACITY = 3000
FRAMES = 2
PP = dict(num_classes=1, grid_ny=80, grid_nx=80, voxel_size=[0.2, 0.2, 4.0],
          pc_range=[0.0, -8.0, -3.0, 16.0, 8.0, 1.0],
          rpn_layer_nums=[1, 1, 1], rpn_filters=[16, 32, 64],
          rpn_up_filters=[16, 16, 16], max_voxels=400,
          max_points_per_voxel=8, anchor_strides=[[0.4, 0.4, 0.0]],
          anchor_offsets=[[0.2, -7.8, -1.78]])
CP = dict(task_num_classes=[1, 2], grid_ny=80, grid_nx=80,
          voxel_size=[0.2, 0.2, 8.0], pc_range=[-8.0, -8.0, -5.0, 8.0, 8.0,
                                                3.0],
          pfn_filters=[16, 16], rpn_layer_nums=[1, 1, 1],
          rpn_filters=[16, 32, 64], rpn_up_filters=[16, 16, 16],
          max_voxels=400, max_points_per_voxel=8, out_size_factor=4,
          refine_hidden=32, num_proposals=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(cfg):
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v for k, v in cfg.items()}


def _clouds(root, pcr, features, seed):
    """FRAMES clouds of 3500 points as .bin files: 1500 in a 2 m square
    (pillars over the point cap), the rest spread over the range."""
    rs = np.random.RandomState(seed)
    os.makedirs(root)
    clouds = []
    for i in range(FRAMES):
        lo = [pcr[0], pcr[1], -2.0] + [0.0] * (features - 3)
        hi = [pcr[3], pcr[4], 0.5] + [1.0] * (features - 3)
        pts = rs.uniform(lo, hi, (3500, features))
        pts[:1500, :2] = pts[:1500, :2] * 0.125 + [pcr[0] + 3.0, 0.5]
        pts = pts.astype(np.float32)
        pts.tofile(os.path.join(root, f"{i:06d}.bin"))
        clouds.append(pts)
    return clouds


def _occupancy(cloud, cfg):
    """(occupied pillars, the most points in one) of the cloud cut to the
    capacity."""
    xy = cloud[:CAPACITY, :2] - np.float32(cfg["pc_range"][:2])
    cells = np.floor(xy / np.float32(cfg["voxel_size"][:2])).astype(int)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    return len(counts), counts.max()


def _padded(cloud, features):
    pts = np.zeros((1, CAPACITY, features), np.float32)
    raw = cloud[:CAPACITY]
    pts[0, : len(raw)] = raw
    return pts, np.arange(CAPACITY)[None] < len(raw)


def _run_port(tmp_path, kind, cls, model_cfg, state, data_type):
    """The port's CLI on the clouds under ``tmp_path / kind`` with ``state``
    as its checkpoint; returns the frames' JSON. ``cls.voxelize`` is
    spied on: every frame reaches it at the config's capacity."""
    config = tmp_path / f"{kind}.yaml"
    config.write_text(yaml.safe_dump({
        "model": model_cfg, "data": {"type": data_type,
                                     "max_points": CAPACITY}}))
    ckpt = str(tmp_path / "ckpt" / kind)
    save_pytree(ckpt, {"model": state, "step": 0})
    out = tmp_path / f"out_{kind}"
    orig = cls.voxelize
    with mock.patch.object(cls, "voxelize", autospec=True,
                           side_effect=lambda m, p, k: orig(m, p, k)) as spy:
        summary = tinfer.main(["--config", str(config), "--checkpoint", ckpt,
                               "--input", str(tmp_path / kind),
                               "--output", str(out), "--device", "cpu"])
    assert summary["frames"] == FRAMES and summary["p50_ms"] > 0
    assert [c.args[1].shape[1] for c in spy.call_args_list] == \
        [CAPACITY] * FRAMES
    frames = []
    for f in sorted(glob.glob(str(out / "*.json"))):
        with open(f) as g:
            frames.append(json.load(g))
    return frames


def _assert_frame(frame, name, ref):
    assert frame["frame"] == name
    np.testing.assert_array_equal(np.array(frame["labels"]),
                                  np.asarray(ref["labels"][0]))
    np.testing.assert_allclose(np.array(frame["scores"], np.float32),
                               np.asarray(ref["scores"][0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.array(frame["boxes"], np.float32),
                               np.asarray(ref["boxes"][0]), rtol=0,
                               atol=1e-4)
    assert (np.asarray(ref["labels"][0]) >= 0).sum() > 2


def test_reference_reads_a_missing_anchors_section(tmp_path):
    (tmp_path / "in").mkdir()
    for name in ("pointpillars_car_kitti.yaml",
                 "pointpillars_ped_cycle_kitti.yaml"):
        with pytest.raises(AttributeError, match="anchors"):
            jinfer.main(["--config", os.path.join(CONFIGS, name),
                         "--input", str(tmp_path / "in"),
                         "--output", str(tmp_path / "out")])


def test_reference_refuses_the_two_stage_model(tmp_path):
    (tmp_path / "in").mkdir()
    with pytest.raises(SystemExit, match="image-stream"):
        jinfer.main(["--config", os.path.join(
            CONFIGS, "centerpoint_pp_nusc_two_stage.yaml"),
            "--input", str(tmp_path / "in"),
            "--output", str(tmp_path / "out")])


def test_reference_voxelizes_into_16000_voxels_of_60000_points(tmp_path):
    from minddet_tpu.core.config import Config
    from minddet_tpu.ops import voxelize as jvox

    config = os.path.join(CONFIGS, "centerpoint_pp_nusc.yaml")
    cfg = Config.fromfile(config)
    assert (cfg.model.max_voxels, cfg.data.max_points) == (30000, 120000)
    _clouds(str(tmp_path / "in"), cfg.model.pc_range, 5, 0)

    class Stop(Exception):
        pass

    seen = {}

    def spy(points, mask, vs, pcr, max_voxels, max_points):
        seen.update(n=points.shape[1], max_voxels=max_voxels)
        raise Stop

    with mock.patch.object(jvox, "voxelize_batch", spy), \
            pytest.raises(Stop):
        jinfer.main(["--config", config, "--input", str(tmp_path / "in"),
                     "--output", str(tmp_path / "out")])
    assert seen == {"n": 60000, "max_voxels": 16000}


def test_pointpillars_frames_match_the_reference(tmp_path):
    clouds = _clouds(str(tmp_path / "pp"), PP["pc_range"], 4, 1)
    jm = JPP(**_kw(PP))
    pts, mask = _padded(clouds[0], 4)
    vox = voxelize_batch(jnp.asarray(pts), jnp.asarray(mask),
                         tuple(PP["voxel_size"]), tuple(PP["pc_range"]),
                         PP["max_voxels"], PP["max_points_per_voxel"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), vox.voxels, vox.num_points, vox.coords))
    variables = random_variables({"params": dict(shapes["params"]),
                                  "batch_stats": dict(shapes["batch_stats"])},
                                 seed=2)
    state = pointpillars_from_flax(PointPillars(**_kw(PP)),
                                   variables).state_dict()
    frames = _run_port(tmp_path, "pp", PointPillars,
                       dict(PP, type="PointPillars"), state, "kitti")
    anchors = jm.anchor_set()["anchors"]
    near = rbbox_to_near_bbox(anchors[:, jnp.array([0, 1, 3, 4, 6])])

    @jax.jit
    def ref_program(v, points, points_mask):
        vx = voxelize_batch(points, points_mask, tuple(PP["voxel_size"]),
                            tuple(PP["pc_range"]), PP["max_voxels"],
                            PP["max_points_per_voxel"])
        amask = jax.vmap(lambda c: anchors_bev_area_mask(
            c, near, (80, 80), tuple(PP["voxel_size"]),
            tuple(PP["pc_range"]), jm.anchor_area_threshold))(vx.coords)
        return jm.apply(v, vx.voxels, vx.num_points, vx.coords, anchors,
                        amask, method=jm.predict)

    assert len(frames) == FRAMES
    for i, cloud in enumerate(clouds):
        pillars, most = _occupancy(cloud, PP)
        assert pillars > PP["max_voxels"] and most > PP["max_points_per_voxel"]
        pts, mask = _padded(cloud, 4)
        ref = jax.device_get(ref_program(variables, jnp.asarray(pts),
                                         jnp.asarray(mask)))
        _assert_frame(frames[i], f"{i:06d}.bin", ref)


def test_two_stage_frames_match_the_reference(tmp_path):
    clouds = _clouds(str(tmp_path / "cp"), CP["pc_range"], 5, 2)
    jm = JCenterPointTwoStage(**_kw(CP))
    pts, mask = _padded(clouds[0], 5)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        method=jm.predict_refined))
    variables = random_variables({"params": dict(shapes["params"]),
                                  "batch_stats": dict(shapes["batch_stats"])},
                                 seed=3)
    kw = {k: v for k, v in _kw(CP).items() if k != "num_proposals"}
    state = centerpoint_from_flax(
        CenterPointTwoStage(**kw, num_proposals=CP["num_proposals"]),
        variables).state_dict()
    frames = _run_port(tmp_path, "cp", CenterPointTwoStage,
                       dict(CP, type="CenterPointTwoStage"), state,
                       "nuscenes")

    @jax.jit
    def ref_program(v, points, points_mask):
        vx = voxelize_batch(points, points_mask, tuple(CP["voxel_size"]),
                            tuple(CP["pc_range"]), CP["max_voxels"],
                            CP["max_points_per_voxel"])
        return jm.apply(v, vx.voxels, vx.num_points, vx.coords,
                        method=jm.predict)

    assert len(frames) == FRAMES
    for i, cloud in enumerate(clouds):
        pillars, most = _occupancy(cloud, CP)
        assert pillars > CP["max_voxels"] and most > CP["max_points_per_voxel"]
        pts, mask = _padded(cloud, 5)
        ref = jax.device_get(ref_program(variables, jnp.asarray(pts),
                                         jnp.asarray(mask)))
        _assert_frame(frames[i], f"{i:06d}.bin", ref)


def test_infer_defaults_to_the_card(tmp_path):
    """Without ``--device`` the CLI asks for the GPU: on a host without one
    it raises before reading a cloud."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    (tmp_path / "in").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.main(["--config", os.path.join(
            CONFIGS, "pointpillars_car_kitti.yaml"),
            "--input", str(tmp_path / "in"),
            "--output", str(tmp_path / "out")])
