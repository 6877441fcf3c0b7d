"""The port's padded CenterPoint path and double-flip TTA vs the JAX
package's, on the CPU.

The tiny single-stage model of ``test_torch_centerpoint.py`` (grid 64x64 over
a range symmetric about 0, two tasks over (1, 2) classes, RPN (1, 1, 1)
with the nuScenes up strides, a two-layer PFN (16, 16), max_voxels 256, 8
points per pillar), its variables from ``init`` on voxels, numpy-random,
with the heatmap and box-size convs calibrated on the clouds (as that file
does) so that scores spread over (0, 1) and boxes overlap.

- ``CenterPoint.predict`` on voxels and ``predict_tta_double_flip`` (four
  flipped copies of each cloud as one batch, the maps unflipped and
  merged, one decode): kept labels exact, scores 1e-5, boxes 1e-4.
- ``loss`` on voxels with f64 compute over f32 parameters: the parts 1e-6,
  every gradient within 1e-5 of its largest element (a conv bias under a
  train-mode BN, whose gradient is rounding noise on both sides, within
  1e-6 of the model's largest gradient on both).
- ``unflip_task_map`` for the four flips, exactly; the TTA's ValueError on
  a range that is not symmetric about 0.
- ``configs/centerpoint_pp_waymo.yaml``, a fault of the reference: its
  grid of 468 cells and RPN strides (2, 2, 2) with up strides (0.5, 1, 2)
  give maps of 117, 117 and 118 cells, so the neck's concatenation raises
  in both packages.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_centerpoint import TINY as TINY_TWO_STAGE
from test_torch_centerpoint import _clouds
from test_torch_pointpillars import random_variables

from minddet_tpu.models.detectors.centerpoint import CenterPoint as JCP
from minddet_tpu.models.detectors.centerpoint import (
    unflip_task_map as j_unflip)
from minddet_tpu.ops import voxelize as jvox
from minddet_tpu_torch.entry import (CP_CONFIG, CP_TWO_STAGE_CONFIG,
                                     CP_WAYMO_CONFIG, NUSC_CLOUD_POINTS,
                                     build_centerpoint, centerpoint_tta_entry,
                                     centerpoint_voxel_entry, read_config)
from minddet_tpu_torch.models.detectors.centerpoint import (
    FLIPS, CenterPoint, CenterPointTwoStage, unflip_task_map)
from minddet_tpu_torch.utils.convert import centerpoint_from_flax

TINY = {k: v for k, v in TINY_TWO_STAGE.items() if k != "refine_hidden"}
PREDICT = dict(score_threshold=0.1, nms_pre=128, nms_post=24, nms_iou=0.2)
HM_SPREAD = 2.0
HM_CENTRE = (-3.5, -1.5)  # per task, in logits
CANCELLED = 1e-6
MAPS = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2, "hm": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(variables, dtype=torch.float32):
    model = centerpoint_from_flax(CenterPoint(**TINY, dtype=dtype),
                                  variables)
    return model.eval().to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def cp():
    """The JAX model, its calibrated variables, the clouds and their
    voxels."""
    jm = JCP(**TINY)
    pts, mask = _clouds()
    vox = jax.tree_util.tree_map(np.array, jvox.voxelize_batch(
        jnp.asarray(pts), jnp.asarray(mask), TINY["voxel_size"],
        TINY["pc_range"], TINY["max_voxels"], TINY["max_points_per_voxel"]))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(vox.voxels),
        jnp.asarray(vox.num_points), jnp.asarray(vox.coords)))
    v = jax.tree_util.tree_map(np.array, random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, seed=3))
    with torch.no_grad():
        preds = _port(v).forward_voxels(*(torch.from_numpy(a) for a in (
            vox.voxels, vox.num_points, vox.coords)))
    for t, pred in enumerate(preds):
        task = v["params"]["head"][f"task{t}"]
        hm = pred["hm"].numpy()
        gain = HM_SPREAD / hm.std((0, 1, 2))
        out = task["hm_out"]
        out["bias"] = ((out["bias"] - hm.mean((0, 1, 2))) * gain
                       + HM_CENTRE[t]).astype(np.float32)
        out["kernel"] = (out["kernel"] * gain).astype(np.float32)
        task["dim_out"]["kernel"] = task["dim_out"]["kernel"] * np.float32(0.3)
        task["dim_out"]["bias"] = task["dim_out"]["bias"] + np.float32(0.9)
    return dict(jm=jm, variables=v, pts=pts, mask=mask, vox=vox,
                port=_port(v))


def _assert_detections(det, ref):
    np.testing.assert_array_equal(det["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(det["scores"].numpy(), ref["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy(), ref["boxes"], rtol=0,
                               atol=1e-4)
    kept = (ref["labels"] >= 0).reshape(2, 2, 24).sum(-1)
    assert (kept > 2).all()
    assert set(np.unique(ref["labels"])) == {-1, 0, 1, 2}


def test_voxel_predict_matches_jax(cp):
    jm, vox = cp["jm"], cp["vox"]
    args = (vox.voxels, vox.num_points, vox.coords)
    ref = jax.device_get(jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.predict, **PREDICT))(
        cp["variables"], *(jnp.asarray(a) for a in args)))
    det = cp["port"].predict(*(torch.from_numpy(a) for a in args), **PREDICT)
    assert det["boxes"].shape == (2, 48, 9)
    _assert_detections(det, ref)
    got = cp["port"].predict_from_points_padded(
        torch.from_numpy(cp["pts"]), torch.from_numpy(cp["mask"]), **PREDICT)
    for k in ("boxes", "scores", "labels"):
        assert torch.equal(got[k], det[k]), k


def test_tta_double_flip_matches_jax(cp):
    jm = cp["jm"]
    ref = jax.device_get(jax.jit(lambda v, p, m: jm.apply(
        v, p, m, method=jm.predict_tta_double_flip, **PREDICT))(
        cp["variables"], jnp.asarray(cp["pts"]), jnp.asarray(cp["mask"])))
    det = cp["port"].predict_tta_double_flip(
        torch.from_numpy(cp["pts"]), torch.from_numpy(cp["mask"]), **PREDICT)
    _assert_detections(det, ref)
    plain = cp["port"].predict_from_points_padded(
        torch.from_numpy(cp["pts"]), torch.from_numpy(cp["mask"]), **PREDICT)
    assert not torch.equal(det["scores"], plain["scores"])


def test_voxel_loss_and_gradients_match_jax_f64(cp):
    """``loss`` on voxels and the head's targets of a few boxes (the port's
    ``_stage1_example``, on both sides), f64 compute: parts 1e-6, every
    gradient within 1e-5 of its largest element."""
    rs = np.random.RandomState(9)
    gt = np.zeros((2, 6, 9), np.float32)
    gt[:, :4, :2] = rs.uniform(-5, 5, (2, 4, 2))
    gt[:, :4, 2] = -1.0
    gt[:, :4, 3:6] = rs.uniform(1.0, 3.0, (2, 4, 3))
    gt[:, :4, 6:] = rs.uniform(-1, 1, (2, 4, 3))
    gt_mask = np.zeros((2, 6), bool)
    gt_mask[:, :4] = True
    classes = rs.randint(1, 4, (2, 6)).astype(np.int32)
    port = _port(cp["variables"], torch.float64).train()
    example = port._stage1_example({
        "gt_boxes": torch.from_numpy(gt), "gt_mask": torch.from_numpy(gt_mask),
        "gt_classes": torch.from_numpy(classes)})
    vox = cp["vox"]
    batch = {"voxels": vox.voxels, "num_points": vox.num_points,
             "coords": vox.coords,
             **{k: [t.numpy() for t in v] for k, v in example.items()}}
    with jax.enable_x64(True):
        jm = JCP(**TINY, dtype=jnp.float64)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        variables = cp["variables"]

        def loss(params):
            out, state = jm.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  jbatch, train=True, method=jm.loss,
                                  mutable=["batch_stats"])
            return out[0], out[1]

        (total, parts), grads = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"]))
    t_total, t_parts = port.loss({k: (torch.from_numpy(v) if isinstance(
        v, np.ndarray) else [torch.from_numpy(t) for t in v])
        for k, v in batch.items()})
    t_total.backward()
    np.testing.assert_allclose(float(t_total.detach()), float(total),
                               rtol=1e-6)
    assert set(t_parts) == set(parts)
    for name in parts:
        np.testing.assert_allclose(float(t_parts[name].detach()),
                                   float(parts[name]), rtol=1e-6,
                                   err_msg=name)
    ref = _port({"params": grads, "batch_stats": variables["batch_stats"]})
    got = dict(port.named_parameters())
    largest = max(float(g.detach().abs().max())
                  for g in ref.parameters())
    cancelled = 0
    for name, g in ref.named_parameters():
        scale = float(g.detach().abs().max())
        err = float((got[name].grad.float() - g.detach()).abs().max())
        if re.search(r"(shared_conv|_conv\d)\.bias$", name):
            # a conv bias under a train-mode BN gets no gradient: rounding
            # noise on both sides (the reference's head losses run in f32)
            cancelled += 1
            assert max(err, scale) <= CANCELLED * largest, (name, err, scale)
        else:
            assert err <= 1e-5 * scale, (name, err, scale)
    assert cancelled == 1 + 6 * len(TINY["task_num_classes"])


@pytest.mark.parametrize("fx,fy", FLIPS)
def test_unflip_task_map_matches_jax(fx, fy):
    rs = np.random.RandomState(int(fx) * 2 + int(fy))
    pred = {k: rs.randn(2, 6, 5, c).astype(np.float32)
            for k, c in MAPS.items()}
    ref = j_unflip({k: jnp.asarray(v) for k, v in pred.items()}, fx, fy)
    got = unflip_task_map({k: torch.from_numpy(v) for k, v in pred.items()},
                          fx, fy)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_tta_raises_on_a_range_not_symmetric_about_0(cp):
    shifted = dict(TINY, pc_range=(0.0, -6.4, -5.0, 12.8, 6.4, 3.0))
    jm = JCP(**shifted)
    with pytest.raises(ValueError, match="symmetric"):
        jm.apply(cp["variables"], jnp.asarray(cp["pts"]),
                 jnp.asarray(cp["mask"]), method=jm.predict_tta_double_flip)
    port = centerpoint_from_flax(CenterPoint(**shifted).eval(),
                                 cp["variables"])
    with pytest.raises(ValueError, match="symmetric"):
        port.predict_tta_double_flip(torch.from_numpy(cp["pts"]),
                                     torch.from_numpy(cp["mask"]))


def test_waymo_config_fails_in_both_packages():
    """A fault of the reference that the port copies: at
    ``configs/centerpoint_pp_waymo.yaml`` the neck's three upsampled maps
    come out 117, 117 and 118 cells wide (grid 468, strides (2, 2, 2), up
    strides (0.5, 1, 2)), and their concatenation raises: ``jnp.
    concatenate`` in the reference's ``init`` (traced, nothing computed),
    ``torch.cat`` in the port's forward (on the meta device, nothing
    computed)."""
    mcfg = read_config(CP_WAYMO_CONFIG)["model"]
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in mcfg.items() if k != "type"}
    jm = JCP(**kwargs)
    pts = jnp.zeros((1, 64, 5))
    with pytest.raises(TypeError, match="117, 117, 128.*118, 118, 128"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), pts,
                                       jnp.ones((1, 64), bool),
                                       method=jm.predict_from_points))
    model = build_centerpoint("cpu", CP_WAYMO_CONFIG).to("meta")
    assert (model.grid_ny, model.task_num_classes) == (468, (3,))
    vox = [torch.zeros(s, dtype=d, device="meta") for s, d in (
        ((1, 32, 20, 5), torch.float32), ((1, 32), torch.int32),
        ((1, 32, 3), torch.int32))]
    with pytest.raises(RuntimeError, match="Expected 117 .* got 118"):
        model.forward_voxels(*vox)


def test_build_centerpoint_reads_the_configs():
    """The nuScenes configs (the two-stage one through its ``_base_``) give
    the models the port builds by default; a loss weight other than the
    port's raises."""
    default = build_centerpoint("cpu")
    two = build_centerpoint("cpu", CP_TWO_STAGE_CONFIG)
    one = build_centerpoint("cpu", CP_CONFIG)
    assert type(two) is CenterPointTwoStage and type(one) is CenterPoint
    for model in (two, one):
        assert (model.grid_ny, model.max_voxels, model.max_points_per_voxel,
                model.task_num_classes) == (512, 30000, 20,
                                            (1, 2, 2, 1, 2, 2))
    assert {k: v.shape for k, v in two.state_dict().items()} == {
        k: v.shape for k, v in default.state_dict().items()}
    for k, v in one.state_dict().items():
        assert torch.equal(v, default.state_dict()[k]), k
    cfg = read_config(CP_CONFIG)
    cfg["model"]["loc_weight"] = 0.5
    with pytest.raises(ValueError, match="loc_weight"):
        build_centerpoint("cpu", cfg)


def test_voxel_entries_without_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entries run there")
    for entry in (centerpoint_voxel_entry, centerpoint_tta_entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_voxel_entries_configuration_on_cpu():
    """Built (not run: full size) on the CPU when asked."""
    predict, (points, mask) = centerpoint_voxel_entry(device="cpu", batch=2)
    tta, _ = centerpoint_tta_entry(device="cpu")
    assert predict.__name__ == "predict_from_points_padded"
    assert tta.__name__ == "predict_tta_double_flip"
    model = predict.__self__
    assert type(model) is CenterPoint and not model.training
    assert points.shape == (2, NUSC_CLOUD_POINTS, 5) and bool(mask.all())
