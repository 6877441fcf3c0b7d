"""The port's PointPillars serving path vs the JAX package's, f32 on the CPU.

A tiny configuration (grid 32x32, RPN (1, 1, 1) / (16, 32, 64) / (16, 16,
16), max_voxels 256, 8 points per pillar; the ``__graft_entry__`` dry-run
model) built as the KITTI config builds it (``rpn_space_to_depth=True``)
and without it. The flax variables are numpy-random (kernels at fan-in
scale, BN statistics off identity, the class head scaled so scores spread
over (0, 1)) and go to the port through ``pointpillars_from_flax``. 600
points per cloud occupy more cells than ``max_voxels``, so the sorted drop
order is exercised.

Tolerances: heads atol 1e-4 / rtol 1e-3 (a dozen f32 conv layers summed in
another order than XLA); the canvas 1e-6; occupancy, anchor mask and the
top-``nms_pre`` indices exact; decoded boxes and IoUs 1e-4. The kept lists
are compared only when no candidate pair's IoU lies within 1e-5 of the
NMS threshold (there a rounding difference may flip a keep and the rest of
the list); the seed is one where none does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rotated_iou import _np_rotated_iou

from minddet_tpu.models.detectors.pointpillars import PointPillars as JPP
from minddet_tpu.ops import anchors as janchors
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops.nms import rotated_nms as j_rotated_nms
from minddet_tpu.ops.rotated_iou import rotated_iou_bev as j_iou
from minddet_tpu_torch.entry import (CLOUD_POINTS, build_pointpillars,
                                     pointpillars_entry, synthetic_clouds)
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.ops import anchors as tanchors
from minddet_tpu_torch.ops import box as tbox
from minddet_tpu_torch.ops.nms import greedy_keep_from_iou, rotated_nms
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_bev
from minddet_tpu_torch.utils.convert import pointpillars_from_flax

PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
TINY = dict(num_classes=1, grid_ny=32, grid_nx=32, voxel_size=(0.2, 0.2, 4.0),
            pc_range=PCR, rpn_layer_nums=(1, 1, 1), rpn_filters=(16, 32, 64),
            rpn_up_filters=(16, 16, 16), max_voxels=256,
            max_points_per_voxel=8, anchor_strides=((0.4, 0.4, 0.0),),
            anchor_offsets=((0.2, -3.0, -1.78),))
PREDICT = dict(score_threshold=0.09, nms_pre=192, nms_post=64, nms_iou=0.1)
NEAR = 1e-5


def random_variables(shapes, seed=0, cls_gain=8.0):
    """numpy-random flax variables of the given shapes."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            gain = cls_gain if "conv_cls" in names else 1.0
            return (rs.randn(*s.shape) * gain / np.sqrt(fan_in)).astype(
                np.float32)
        if names[-1] in ("scale", "var"):
            return rs.uniform(0.6, 1.4, s.shape).astype(np.float32)
        return (rs.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=[True, False], ids=["s2d", "plain"])
def setup(request):
    jm = JPP(**TINY, rpn_space_to_depth=request.param)
    pts, mask = synthetic_clouds(2, PCR, num_points=600, seed=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        method=jm.predict_from_points))
    variables = random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])})

    def preds(mdl, p, m):
        canvas, occ = mdl._canvas_from_points(p, m, False)
        return mdl._preds_from_canvas(canvas, False), occ

    j_preds, j_occ = jax.jit(lambda v, p, m: jm.apply(v, p, m, method=preds))(
        variables, jnp.asarray(pts), jnp.asarray(mask))
    j_det = jax.jit(lambda v, p, m: jm.apply(
        v, p, m, method=jm.predict_from_points, **PREDICT))(
        variables, jnp.asarray(pts), jnp.asarray(mask))
    port = pointpillars_from_flax(PointPillars(**TINY).eval(), variables)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.no_grad():
        t_preds, t_amask = port(tp, tm)
    t_det = port.predict_from_points(tp, tm, **PREDICT)
    return dict(jm=jm, variables=variables, pts=pts, mask=mask, port=port,
                j_preds=jax.device_get(j_preds), j_occ=np.asarray(j_occ),
                j_det=jax.device_get(j_det), t_preds=t_preds,
                t_amask=t_amask, t_det=t_det)


def test_heads_match_jax(setup):
    for name, ref in setup["j_preds"].items():
        got = setup["t_preds"][name].numpy()
        assert got.shape == ref.shape == (2, 512, {"cls_preds": 1,
                                                   "box_preds": 7,
                                                   "dir_preds": 2}[name])
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_canvas_occupancy_and_anchor_mask_match_jax(setup):
    port = setup["port"]
    tp, tm = torch.from_numpy(setup["pts"]), torch.from_numpy(setup["mask"])
    with torch.no_grad():
        canvas, occ = port.canvas_from_points(tp, tm)
    np.testing.assert_array_equal(occ.numpy(), setup["j_occ"])
    assert 256 == occ.sum(dim=(1, 2)).min()  # max_voxels pillars kept
    jm = setup["jm"]
    feature_size, configs = jm.anchor_layout()
    grid_fn = janchors.make_grid_area_mask(
        (32, 32), jm.voxel_size, jm.pc_range, feature_size, configs, 1.0)
    ref_mask = np.asarray(jax.vmap(grid_fn.from_occ)(setup["j_occ"]))
    np.testing.assert_array_equal(setup["t_amask"].numpy(), ref_mask)
    assert 0 < ref_mask.mean() < 1
    if not jm.rpn_space_to_depth:  # the canvas in the JAX model's layout
        ref = jm.apply(setup["variables"], jnp.asarray(setup["pts"]),
                       jnp.asarray(setup["mask"]), False,
                       method=jm._canvas_from_points)[0]
        np.testing.assert_allclose(canvas.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref)[..., :-1], rtol=0,
                                   atol=1e-6)


def _jax_candidates(setup):
    """The reference's ``_predict_from_preds`` up to the NMS, per sample."""
    jm = setup["jm"]
    preds = setup["j_preds"]
    anchors = jm.anchor_set()["anchors"]
    scores = jax.nn.sigmoid(preds["cls_preds"]).max(-1)
    scores = jnp.where(jnp.asarray(setup["t_amask"].numpy()), scores, 0.0)
    out = []
    for i in range(2):
        k_scores, k_idx = jax.lax.top_k(scores[i], PREDICT["nms_pre"])
        boxes = jbox.second_box_decode(preds["box_preds"][i][k_idx],
                                       anchors[k_idx])
        dir_lab = jnp.argmax(preds["dir_preds"][i][k_idx], -1)
        flip = (boxes[:, 6] > 0) != (dir_lab == 1)
        rot = jnp.where(flip, boxes[:, 6] + jnp.pi, boxes[:, 6])
        boxes = boxes.at[:, 6].set(jbox.limit_period(rot, 0.5, 2 * jnp.pi))
        out.append((np.asarray(k_scores), np.asarray(k_idx),
                    np.asarray(boxes)))
    return out


def test_predict_from_points_matches_jax(setup):
    port = setup["port"]
    cand = port.decode_candidates(setup["t_preds"], setup["t_amask"],
                                  PREDICT["nms_pre"])
    for i, (k_scores, k_idx, boxes) in enumerate(_jax_candidates(setup)):
        np.testing.assert_array_equal(cand["anchor"][i].numpy(), k_idx)
        np.testing.assert_allclose(cand["scores"][i].numpy(), k_scores,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(cand["boxes"][i].numpy(), boxes, rtol=0,
                                   atol=1e-4)
        bev = boxes[:, [0, 1, 3, 4, 6]]
        ref_iou = np.array(j_iou(jnp.asarray(bev), jnp.asarray(bev)))
        t_bev = cand["boxes"][i][:, [0, 1, 3, 4, 6]].contiguous()
        got_iou = rotated_iou_bev(t_bev, t_bev).numpy()
        # where the reference's XLA form misses a float64 polygon clip
        # (test_torch_rotated_iou.py::test_reference_xla_form_*), the port
        # must match the clip instead
        bad = np.argwhere(np.abs(got_iou - ref_iou) > 1e-4)
        assert len(bad) <= 4
        for a, b in bad:
            golden = _np_rotated_iou(bev[a].astype(np.float64),
                                     bev[b].astype(np.float64))
            assert abs(got_iou[a, b] - golden) < 1e-5
            # the NMS decision is the same either way
            assert (got_iou[a, b] > 0.1) == (ref_iou[a, b] > 0.1)
            ref_iou[a, b] = got_iou[a, b]
        np.testing.assert_allclose(got_iou, ref_iou, rtol=0, atol=1e-4)
        valid = k_scores > PREDICT["score_threshold"]
        pair = valid[:, None] & valid[None, :]
        near = int((pair & (np.abs(ref_iou - PREDICT["nms_iou"]) < NEAR)
                    ).sum())
        assert near == 0, f"{near} candidate pairs near the threshold"
        assert valid.sum() > 50  # the NMS has work to do
    det, ref = setup["t_det"], setup["j_det"]
    np.testing.assert_array_equal(det["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    kept = (det["labels"] >= 0).sum(1)
    assert (kept > 3).all() and (kept < PREDICT["nms_post"]).all()
    np.testing.assert_allclose(det["scores"].numpy(), ref["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy(), ref["boxes"], rtol=0,
                               atol=1e-4)
    assert det["boxes"].shape == (2, 64, 7)
    assert 1 <= det["nms_passes"] <= PREDICT["nms_pre"]


def _nms_case(seed, n=120):
    """Car boxes in a 12 m square (so they overlap), scores on a coarse
    grid (so some tie), away from the IoU threshold."""
    rs = np.random.RandomState(seed)
    boxes = np.stack([rs.uniform(0, 12, n), rs.uniform(0, 12, n),
                      1.6 * np.exp(rs.randn(n) * 0.1),
                      3.9 * np.exp(rs.randn(n) * 0.1),
                      rs.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    scores = np.round(rs.uniform(0, 1, n), 1).astype(np.float32)
    return boxes, scores


def test_rotated_nms_matches_jax():
    cases = [_nms_case(s) for s in (0, 1)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    scores = torch.from_numpy(np.stack([c[1] for c in cases]))
    idx, count, passes = rotated_nms(boxes, scores, 0.1, 0.05, 80)
    assert passes > 1
    for i, (b, s) in enumerate(cases):
        iou = np.asarray(j_iou(jnp.asarray(b), jnp.asarray(b)))
        assert not (np.abs(iou - 0.1) < NEAR).any()
        assert len(set(s.tolist())) < len(s)  # score ties
        ref_idx, ref_count = j_rotated_nms(jnp.asarray(b), jnp.asarray(s),
                                           0.1, 0.05, 80)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_idx))
        assert int(count[i]) == int(ref_count)


def test_greedy_keep_batch_equals_per_sample():
    """A converged sample stays put while another still iterates."""
    rs = np.random.RandomState(4)
    iou = torch.from_numpy(rs.uniform(0, 0.3, (3, 50, 50)).astype(np.float32))
    iou = (iou + iou.transpose(1, 2)) / 2
    iou[1] = 0.0  # nothing suppresses: converges in one pass
    scores = torch.from_numpy(rs.uniform(0, 1, (3, 50)).astype(np.float32))
    valid = scores > 0.1
    keep, passes = greedy_keep_from_iou(iou, scores, valid, 0.2)
    worst = 0
    for i in range(3):
        k, p = greedy_keep_from_iou(iou[i:i + 1], scores[i:i + 1],
                                    valid[i:i + 1], 0.2)
        assert torch.equal(k[0], keep[i])
        worst = max(worst, p)
    assert passes == worst
    assert torch.equal(keep[1], valid[1])


def test_box_ops_match_jax():
    rs = np.random.RandomState(6)
    enc = (rs.randn(40, 7) * 0.5).astype(np.float32)
    anc = np.concatenate([rs.uniform(-30, 30, (40, 3)),
                          rs.uniform(0.5, 4, (40, 3)),
                          rs.uniform(-4, 4, (40, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(
        tbox.second_box_decode(torch.from_numpy(enc),
                               torch.from_numpy(anc)).numpy(),
        np.asarray(jbox.second_box_decode(jnp.asarray(enc),
                                          jnp.asarray(anc))),
        rtol=1e-6, atol=1e-5)
    ang = rs.uniform(-10, 10, 100).astype(np.float32)
    np.testing.assert_allclose(
        tbox.limit_period(torch.from_numpy(ang), 0.5, 2 * np.pi).numpy(),
        np.asarray(jbox.limit_period(jnp.asarray(ang), 0.5, 2 * jnp.pi)),
        rtol=0, atol=1e-5)
    bev = anc[:, [0, 1, 3, 4, 6]]
    np.testing.assert_allclose(
        tbox.rbbox_to_near_bbox(torch.from_numpy(bev)).numpy(),
        np.asarray(jbox.rbbox_to_near_bbox(jnp.asarray(bev))), rtol=0,
        atol=1e-5)


def test_kitti_anchors_and_area_mask_match_jax():
    """The full KITTI car layout: 248 x 216 x 2 = 107,136 anchors, and the
    anchor-area mask of a random occupancy map."""
    jm = JPP()
    feature_size, configs = jm.anchor_layout()
    tconfigs = [tanchors.ClassAnchorConfig(*c) for c in configs]
    ref = janchors.generate_anchors(feature_size, configs)
    got = tanchors.generate_anchors(feature_size, tconfigs)
    assert got["anchors"].shape == (107136, 7)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    occ = (np.random.RandomState(0).uniform(size=(2, 496, 432)) < 0.005
           ).astype(np.float32)
    grid_fn = janchors.make_grid_area_mask(
        (496, 432), jm.voxel_size, jm.pc_range, feature_size, configs, 1.0)
    ref_mask = np.asarray(jax.vmap(grid_fn.from_occ)(occ))
    got_mask = tanchors.make_grid_area_mask(
        (496, 432), jm.voxel_size, jm.pc_range, feature_size, tconfigs,
        1.0)(torch.from_numpy(occ))
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    assert 0.1 < ref_mask.mean() < 0.9


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pointpillars_entry()


def test_entry_configuration_on_cpu():
    """The serving configuration, built (not run: it is full size) on the
    CPU when asked: KITTI car, 107,136 anchors, 18,000 points per cloud
    that occupy more cells than max_voxels."""
    predict, (points, mask) = pointpillars_entry(device="cpu", batch=2)
    model = predict.__self__
    assert isinstance(model, PointPillars) and not model.training
    assert points.shape == (2, CLOUD_POINTS, 4) and bool(mask.all())
    assert model.anchors.shape == (107136, 7)
    assert (model.grid_ny, model.grid_nx, model.max_voxels,
            model.max_points_per_voxel, model.voxel_drop_order) == (
        496, 432, 16000, 32, "sorted")
    assert sum(p.numel() for p in model.parameters()) == sum(
        p.numel() for p in build_pointpillars("cpu").parameters())
    pts = points.numpy()
    cells = (np.floor((pts[..., 1] + 39.68) / 0.16) * 432
             + np.floor(pts[..., 0] / 0.16))
    occupied = min(len(np.unique(c)) for c in cells)
    assert 16000 < occupied < CLOUD_POINTS
