"""The port's two-stage CenterPoint serving path vs the JAX package's, f32 on
the CPU.

A tiny two-stage model (grid 64x64, two tasks over (1, 2) classes, RPN
(1, 1, 1) / (16, 32, 64) / (16, 16, 16) with the nuScenes up strides (0.5,
1, 2), a two-layer PFN (16, 16) so that the non-last layer and the segment
max are on the path, max_voxels 256 and 8 points per pillar, refine width
32), built with the JAX model's ``scatter_extra_channel`` on and off. The
flax variables are numpy-random (kernels at fan-in scale, BN statistics off
identity, the heatmap and box-size convs calibrated on the clouds so that
scores spread over (0, 1) and boxes overlap) and go to the port through
``centerpoint_from_flax``. Each cloud has 900 points, half
of them in a 2 m square: more occupied cells than ``max_voxels`` and pillars
over the point cap, so both overflows are exercised.

The JAX model runs eagerly (nothing here runs twice, and compiling the
whole program costs more than running it op by op).

Tolerances: PFN rows 1e-5; BEV map and head maps atol 1e-4 / rtol 1e-3 (f32
conv layers summed in another order than XLA's); candidate and kept indices
exact; decoded and refined boxes 1e-3 (exp and atan2 of the maps), scores
1e-4. The kept lists are compared only when no candidate pair's IoU lies
within 1e-5 of the NMS threshold; the seed is one where none does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables

from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCenterPointTwoStage)
from minddet_tpu.models.heads.center_head import SepHead as JSepHead
from minddet_tpu.models.heads.second_stage import (
    bev_sample_points as j_bev_sample_points)
from minddet_tpu.models.necks.second_rpn import SECONDRPN as JSECONDRPN
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops import voxelize as jvox
from minddet_tpu.ops.decode import simple_topk as j_simple_topk
from minddet_tpu.ops.rotated_iou import rotated_iou_bev as j_iou
from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS, centerpoint_entry)
from minddet_tpu_torch.models.detectors.centerpoint import CenterPointTwoStage
from minddet_tpu_torch.models.heads.center_head import SepHead
from minddet_tpu_torch.models.heads.second_stage import bev_sample_points
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN
from minddet_tpu_torch.ops import box as tbox
from minddet_tpu_torch.ops.decode import simple_topk
from minddet_tpu_torch.utils.convert import (centerpoint_from_flax,
                                             load_from_flax)

PCR = (-6.4, -6.4, -5.0, 6.4, 6.4, 3.0)
TINY = dict(task_num_classes=(1, 2), grid_ny=64, grid_nx=64,
            voxel_size=(0.2, 0.2, 8.0), pc_range=PCR, pfn_filters=(16, 16),
            rpn_layer_nums=(1, 1, 1), rpn_filters=(16, 32, 64),
            rpn_up_filters=(16, 16, 16), max_voxels=256,
            max_points_per_voxel=8, out_size_factor=4, refine_hidden=32)
PREDICT = dict(score_threshold=0.1, nms_pre=128, nms_post=24, nms_iou=0.2)
MAPS = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2}
NEAR = 1e-5
HM_SPREAD = 2.0
HM_CENTRE = (-3.5, -1.5)  # per task, in logits


def _clouds(b=2, n=900, seed=1):
    rs = np.random.RandomState(seed)
    lo = np.array([PCR[0], PCR[1], -2.0, 0.0, 0.0])
    hi = np.array([PCR[3], PCR[4], 0.5, 1.0, 0.45])
    pts = rs.uniform(lo, hi, (b, n, 5))
    pts[:, : n // 2, :2] = rs.uniform(-1.0, 1.0, (b, n // 2, 2))
    mask = np.ones((b, n), bool)
    mask[:, -20:] = False  # a padded tail
    return pts.astype(np.float32), mask


def _cp_variables(shapes, seed, pts, mask):
    """``random_variables``, then the heads calibrated on the clouds (a
    forward of the port with the uncalibrated variables gives the heatmap
    logits' statistics): every heatmap class's logits are brought to std
    ``HM_SPREAD`` around its task's ``HM_CENTRE`` (task 0 has few peaks
    above the score threshold, task 1 many), and the box-size maps to
    about 2.5 m (sizes are exp(dim)), so that the NMS suppresses."""
    v = jax.tree_util.tree_map(
        np.array, random_variables(shapes, seed))
    port = centerpoint_from_flax(CenterPointTwoStage(**TINY).eval(), v)
    with torch.no_grad():
        preds = port(torch.from_numpy(pts), torch.from_numpy(mask))
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
    return v


def _stages(mdl, p, m):
    sv = jvox.voxelize_stream_batch(
        p, m, tuple(mdl.voxel_size), tuple(mdl.pc_range), mdl.max_voxels,
        mdl.max_points_per_voxel, mdl.voxel_drop_order)
    h = mdl.reader.stream(sv.feats, sv.keep, sv.first, sv.last, train=False,
                          bound=mdl.max_points_per_voxel)
    bev = mdl._bev_from_points_stream(p, m, False)
    preds = mdl.head(bev, train=False)
    kw = dict(pc_range=mdl.pc_range, voxel_size=mdl.voxel_size,
              out_size_factor=mdl.out_size_factor)
    proposals = mdl.head.decode_boxes(preds, k=16, **kw)
    return sv.last, sv.keep, h, bev, preds, proposals


@pytest.fixture(scope="module", params=[True, False], ids=["sc65", "sc64"])
def setup(request):
    jm = JCenterPointTwoStage(**TINY, num_proposals=16,
                              scatter_extra_channel=request.param)
    pts, mask = _clouds()
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jp, jmask, method=jm.predict_refined))
    variables = _cp_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, 3, pts, mask)
    j_last, j_keep, j_h, j_bev, j_preds, j_prop = jax.device_get(
        jm.apply(variables, jp, jmask, method=_stages))
    j_det = jax.device_get(jm.apply(variables, jp, jmask,
                                    method=jm.predict_from_points, **PREDICT))
    j_ref = jax.device_get(jm.apply(variables, jp, jmask,
                                    method=jm.predict_refined, **PREDICT))
    port = centerpoint_from_flax(CenterPointTwoStage(**TINY).eval(),
                                 variables)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.no_grad():
        sv, h = port.pillars_from_points(tp, tm)
        bev = port.bev_from_points_stream(tp, tm)
        preds = port.head(bev)
    return dict(jm=jm, variables=variables, port=port, tp=tp, tm=tm,
                j_last=j_last, j_keep=j_keep, j_h=j_h, j_bev=j_bev,
                j_preds=j_preds, j_prop=j_prop, j_det=j_det, j_ref=j_ref,
                sv=sv, h=h, bev=bev, preds=preds)


def test_pfn_stream_matches_jax_at_last_kept_rows(setup):
    sv, h = setup["sv"], setup["h"]
    np.testing.assert_array_equal(sv.last.numpy(), setup["j_last"])
    np.testing.assert_array_equal(sv.keep.numpy(), setup["j_keep"])
    last = setup["j_last"]
    assert (last.sum(1) == TINY["max_voxels"]).all()  # pillars overflow
    keep = setup["j_keep"]
    assert keep.sum() < setup["tm"].sum()  # and points per pillar do
    assert h.shape == setup["j_h"].shape == (2, 900, 16)
    np.testing.assert_allclose(h.numpy()[last], setup["j_h"][last], rtol=0,
                               atol=1e-5)
    assert np.abs(setup["j_h"][last]).max() > 0.1


def test_bev_map_matches_jax(setup):
    bev = setup["bev"]
    assert bev.is_contiguous(memory_format=torch.channels_last)
    got = bev.permute(0, 2, 3, 1).numpy()
    assert got.shape == setup["j_bev"].shape == (2, 16, 16, 48)
    np.testing.assert_allclose(got, setup["j_bev"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("task", [0, 1])
def test_task_maps_match_jax(setup, task):
    got, ref = setup["preds"][task], setup["j_preds"][task]
    widths = dict(MAPS, hm=TINY["task_num_classes"][task])
    assert set(got) == set(ref) == set(widths)
    for name, width in widths.items():
        assert got[name].shape == ref[name].shape == (2, 16, 16, width)
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    hm = 1 / (1 + np.exp(-ref["hm"]))
    assert hm.min() < 0.1 < 0.5 < hm.max()  # scores spread over (0, 1)


def test_decode_boxes_matches_jax(setup):
    port = setup["port"]
    boxes, scores, labels = port.head.decode_boxes(
        setup["preds"], port.pc_range, port.voxel_size,
        port.out_size_factor, k=16)
    j_boxes, j_scores, j_labels = setup["j_prop"]
    np.testing.assert_array_equal(labels.numpy(), j_labels)
    assert labels.dtype == torch.int32 and len(set(j_labels.ravel())) > 1
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=0, atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), j_boxes, rtol=1e-4, atol=1e-3)
    assert boxes.shape == (2, 16, 9)


def _near_threshold_pairs(setup):
    """Candidate pairs of any (task, sample) whose IoU lies within NEAR of
    the NMS threshold, and how many candidates are valid at all."""
    port = setup["port"]
    cands = port.head.candidates(setup["preds"], port.pc_range,
                                 port.voxel_size, port.out_size_factor,
                                 nms_pre=PREDICT["nms_pre"])
    near = valid_total = 0
    for c in cands:
        for i in range(2):
            bev = c["boxes"][i][:, [0, 1, 3, 4, 8]].numpy()
            iou = np.asarray(j_iou(jnp.asarray(bev), jnp.asarray(bev)))
            valid = c["scores"][i].numpy() > PREDICT["score_threshold"]
            pair = valid[:, None] & valid[None, :]
            near += int((pair & (np.abs(iou - PREDICT["nms_iou"]) < NEAR)
                         ).sum())
            valid_total += int(valid.sum())
    return near, valid_total


def _assert_detections(det, ref, box_atol):
    np.testing.assert_array_equal(det["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(det["scores"].numpy(), ref["scores"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(det["boxes"].numpy(), ref["boxes"], rtol=1e-4,
                               atol=box_atol)


def test_predict_from_points_matches_jax(setup):
    near, valid = _near_threshold_pairs(setup)
    assert near == 0, f"{near} candidate pairs near the NMS threshold"
    assert valid > 100  # the NMS has work to do
    port = setup["port"]
    det = port.predict_from_points(setup["tp"], setup["tm"], **PREDICT)
    ref = setup["j_det"]
    assert det["boxes"].shape == ref["boxes"].shape == (2, 48, 9)
    assert det["labels"].dtype == torch.int32
    _assert_detections(det, ref, 1e-3)
    kept = (ref["labels"] >= 0).reshape(2, 2, 24).sum(-1)
    assert (kept > 2).all() and (kept < 24).any()  # padded slots exist
    assert set(np.unique(ref["labels"])) == {-1, 0, 1, 2}
    assert 1 <= det["nms_passes"] <= PREDICT["nms_pre"]
    # dropped slots: zero boxes and scores
    dropped = ref["labels"] < 0
    assert (det["boxes"].numpy()[dropped] == 0).all()
    assert (det["scores"].numpy()[dropped] == 0).all()


@pytest.mark.parametrize("refine_boxes", [True, False])
def test_predict_refined_matches_jax(setup, refine_boxes):
    port, jm = setup["port"], setup["jm"]
    det = port.predict_refined(setup["tp"], setup["tm"], **PREDICT,
                               refine_boxes=refine_boxes)
    if refine_boxes:
        ref = setup["j_ref"]
    else:
        ref = jax.device_get(jm.apply(
            setup["variables"], jnp.asarray(setup["tp"].numpy()),
            jnp.asarray(setup["tm"].numpy()), method=jm.predict_refined,
            **PREDICT, refine_boxes=False))
    # the refined box is exp(delta) times the proposal's size
    _assert_detections(det, ref, 2e-3)
    stage1 = setup["j_det"]
    valid = ref["labels"] >= 0
    assert np.abs(ref["scores"] - stage1["scores"])[valid].max() > 1e-2
    moved = np.abs(ref["boxes"] - stage1["boxes"])[valid].max()
    assert (moved > 1e-2) == refine_boxes
    assert (det["scores"].numpy()[~valid] == 0).all()


def test_predict_pads_tasks_with_fewer_candidates(setup):
    """With nms_pre above a task's cell count (256 cells x 1 class against
    256 x 2) the tasks' candidate lists differ in length; the stacked NMS
    pads the shorter one and the result is the reference's."""
    port, jm = setup["port"], setup["jm"]
    kw = dict(PREDICT, nms_pre=400, nms_post=300)
    det = port.predict_from_points(setup["tp"], setup["tm"], **kw)
    ref = jax.device_get(jm.apply(
        setup["variables"], jnp.asarray(setup["tp"].numpy()),
        jnp.asarray(setup["tm"].numpy()), method=jm.predict_from_points,
        **kw))
    assert det["boxes"].shape == ref["boxes"].shape == (2, 256 + 300, 9)
    _assert_detections(det, ref, 1e-3)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_branch"])
def test_sep_head_matches_jax(fuse):
    heads = dict({k: (v, 2) for k, v in MAPS.items()}, hm=(3, 2))
    jhead = JSepHead(heads=heads, head_conv=16, fuse_branches=fuse)
    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, 10, 12).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    variables = random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, seed=7)
    ref = jax.device_get(jhead.apply(variables, jnp.asarray(x)))
    port = load_from_flax(SepHead(12, heads, head_conv=16).eval(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert got[name].shape == r.shape == (2, 8, 10, heads[name][0])
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_second_rpn_with_fractional_up_stride_matches_jax():
    """Up strides (0.5, 1, 2): block 0's "upsample" is a 2x2 stride-2 conv
    named ``up0_downconv``; atol 1e-4 / rtol 1e-4."""
    kw = dict(layer_nums=(1, 2, 1), layer_strides=(2, 2, 2),
              num_filters=(8, 16, 16), upsample_strides=(0.5, 1, 2),
              num_upsample_filters=(8, 8, 8))
    jrpn = JSECONDRPN(**kw)
    rs = np.random.RandomState(11)
    x = rs.randn(2, 16, 24, 6).astype(np.float32)
    shapes = jax.eval_shape(lambda: jrpn.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    variables = random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, seed=11)
    assert "up0_downconv" in variables["params"]
    ref = np.asarray(jrpn.apply(variables, jnp.asarray(x)))
    port = load_from_flax(SECONDRPN(6, **kw).eval(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 4, 6, 24)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="does not divide"):
        port(torch.zeros(1, 6, 18, 24))  # block 0's map would be 9 rows


def test_simple_topk_and_corner_ops_match_jax():
    rs = np.random.RandomState(5)
    heat = rs.uniform(size=(2, 6, 7, 3)).astype(np.float32)
    heat[0, 2, 3, 1] = heat[0, 1, 1, 0] = heat[0, 4, 6, 2] = 2.0  # ties
    ref = j_simple_topk(jnp.asarray(heat), k=20)
    got = simple_topk(torch.from_numpy(heat), k=20)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # class-major flat order: among equal scores the lower class first
    assert got[2][0, :3].tolist() == [0, 1, 2]
    assert simple_topk(torch.from_numpy(heat), k=1000)[0].shape == (2, 126)
    centers = rs.randn(4, 5, 2).astype(np.float32)
    dims = rs.uniform(0.5, 4, (4, 5, 2)).astype(np.float32)
    yaw = rs.uniform(-4, 4, (4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tbox.center_to_corner_box2d(*map(torch.from_numpy,
                                         (centers, dims, yaw))).numpy(),
        np.asarray(jbox.center_to_corner_box2d(*map(jnp.asarray,
                                                    (centers, dims, yaw)))),
        rtol=0, atol=1e-5)
    boxes = np.concatenate([centers, yaw[..., None], dims, dims,
                            yaw[..., None]], -1).astype(np.float32)
    np.testing.assert_allclose(
        bev_sample_points(torch.from_numpy(boxes)).numpy(),
        np.asarray(j_bev_sample_points(jnp.asarray(boxes))), rtol=0,
        atol=1e-5)


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        centerpoint_entry()


def test_entry_configuration_on_cpu():
    """The serving configuration, built (not run: it is full size) on the
    CPU when asked: the nuScenes two-stage model, 120,000 points of 5
    features per cloud that occupy more cells than max_voxels."""
    predict, (points, mask) = centerpoint_entry(device="cpu", batch=1)
    model = predict.__self__
    assert isinstance(model, CenterPointTwoStage) and not model.training
    assert predict.__name__ == "predict_refined"
    assert points.shape == (1, NUSC_CLOUD_POINTS, 5) and bool(mask.all())
    assert (model.grid_ny, model.grid_nx, model.max_voxels,
            model.max_points_per_voxel, model.voxel_drop_order,
            model.task_num_classes, model.rpn.out_channels) == (
        512, 512, 30000, 20, "sorted", (1, 2, 2, 1, 2, 2), 384)
    assert model.reader.num_layers == 2
    assert model.reader.pfn0.linear.weight.shape == (32, 10)
    assert model.reader.pfn1.linear.weight.shape == (64, 64)
    assert model.rpn.up0_downconv.weight.shape == (128, 64, 2, 2)
    assert model.refine.fc0.weight.shape == (128, 5 * 384)
    assert float(model.head.task3.hm_out.bias[0]) == pytest.approx(-2.19)
    assert float(model.head.task3.reg_out.bias.abs().max()) == 0.0
    pts = points.numpy()[0]
    cells = (np.floor((pts[:, 1] + 51.2) / 0.2) * 512
             + np.floor((pts[:, 0] + 51.2) / 0.2))
    assert 30000 < len(np.unique(cells)) < NUSC_CLOUD_POINTS
