"""The port's padded voxel path of PointPillars vs the JAX package's, on the
CPU.

- ``voxelize_batch`` exactly (voxels, point counts, coords, voxel counts)
  on clouds that fit, that overflow ``max_voxels``, that overflow the point
  cap, with masked and out-of-range points, and with every point on a cell
  boundary; the stream voxelizer on that cloud too (both drop orders).
- ``decorate_pillar_features`` within 1e-6.
- The padded PFN (one layer and two) and ``scatter_voxel_canvas`` against
  ``PillarFeatureNet`` and ``PointPillarsScatter`` within 1e-5, in eval
  mode and in train mode (and the BN statistics after it).
- ``anchors_bev_area_mask`` exactly; on both KITTI configs' anchors it
  equals ``make_grid_area_mask``, and ``from_occ.from_coords`` equals the
  reference's ``mask_fn``.
- The tiny PointPillars of ``test_torch_pointpillars.py`` (grid 32x32,
  max_voxels 256, 8 points per pillar), variables from ``init`` on voxels:
  ``predict`` on voxels (boxes 1e-4, scores 1e-5, as that file states),
  ``loss`` on voxels with f64 compute (the parts 1e-6: the reference
  computes them in f32; every gradient within 1e-5 of its largest element),
  and the same model with an irregular anchor layout (0.3 m anchor stride
  on 0.2 m cells) through ``predict_from_points`` and ``loss_from_gt``,
  where both packages take the dense branch.
- ``circle_nms``: equal indices and counts.
- Stream vs padded in the port: the canvas is equal under ``first_come``.

The JAX programs run jitted where they run more than op by op costs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import PCR, TINY, random_variables

from minddet_tpu.models.detectors.pointpillars import PointPillars as JPP
from minddet_tpu.models.readers import pillar_encoder as jpe
from minddet_tpu.ops import anchors as janchors
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops import voxelize as jvox
from minddet_tpu.ops.nms import circle_nms as j_circle_nms
from minddet_tpu_torch.entry import (PP_CAR_CONFIG, PP_PED_CYCLE_CONFIG,
                                     pointpillars_config, pointpillars_kwargs,
                                     pointpillars_voxel_entry,
                                     pointpillars_voxel_train_entry)
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.models.readers.pillar_encoder import (
    PillarFeatureNet, scatter_voxel_canvas)
from minddet_tpu_torch.ops import anchors as tanchors
from minddet_tpu_torch.ops import voxelize as tvox
from minddet_tpu_torch.ops.box import rbbox_to_near_bbox
from minddet_tpu_torch.ops.nms import circle_nms
from minddet_tpu_torch.utils.convert import load_from_flax

VS, V, P = TINY["voxel_size"], TINY["max_voxels"], TINY["max_points_per_voxel"]
PREDICT = dict(score_threshold=0.09, nms_pre=192, nms_post=64, nms_iou=0.1)
IRREGULAR = dict(TINY, anchor_strides=((0.3, 0.3, 0.0),),
                 anchor_offsets=((0.15, -3.05, -1.78),))
PARTS = ("loss", "loc_loss", "cls_loss", "dir_loss")
BEV = [0, 1, 3, 4, 6]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(case, b=2, seed=0, n=400):
    """(b, n, 4) f32 points and (b, n) mask over ``PCR`` for a voxelizer
    case."""
    rs = np.random.RandomState(seed)
    lo = np.array([PCR[0], PCR[1], PCR[2], 0.0])
    hi = np.array([PCR[3], PCR[4], PCR[5], 1.0])
    pts = rs.uniform(lo, hi, (b, n, 4))
    mask = np.ones((b, n), bool)
    if case == "fits":  # 150 valid points: no cell over the cap
        mask[:, 150:] = False
    elif case == "points":  # half the points in 4 cells: over the cap
        pts[:, :n // 2, :2] = rs.uniform([1.0, -0.2], [1.4, 0.2],
                                         (b, n // 2, 2))
    elif case == "masked":  # out of range on every axis, masked, padded
        pts[:, :60, 0] = rs.uniform(-2.0, -0.01, (b, 60))
        pts[:, 60:120, 1] = rs.uniform(3.2, 5.0, (b, 60))
        pts[:, 120:180, 2] = rs.choice([-3.5, 1.0, 1.5], (b, 60))
        mask[:, 180:260] = False
        mask[:, -30:] = False
        pts[:, -30:] = 0.0
    elif case == "boundaries":  # every coordinate on a cell boundary
        pts[..., 0] = rs.randint(0, 33, (b, n)) * VS[0] + PCR[0]
        pts[..., 1] = rs.randint(0, 33, (b, n)) * VS[1] + PCR[1]
        pts[..., 2] = rs.choice([PCR[2], PCR[5]], (b, n))
    return pts.astype(np.float32), mask


def _j_voxelize(pts, mask, max_voxels=V, max_points=P):
    return jax.tree_util.tree_map(np.array, jvox.voxelize_batch(
        jnp.asarray(pts), jnp.asarray(mask), VS, PCR, max_voxels, max_points))


def _t_voxelize(pts, mask, max_voxels=V, max_points=P):
    return tvox.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(mask),
                               VS, PCR, max_voxels, max_points)


@pytest.mark.parametrize("case", ["fits", "voxels", "points", "masked",
                                  "boundaries"])
def test_voxelize_batch_matches_jax(case):
    pts, mask = _cloud(case)
    ref, got = _j_voxelize(pts, mask), _t_voxelize(pts, mask)
    assert got.num_points.dtype == got.coords.dtype == torch.int32
    for name in ("voxels", "num_points", "coords", "num_voxels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    counts = ref.num_points
    over_v = (ref.num_voxels == V).all()
    over_p = (counts == P).any()
    assert {"fits": (not over_v and not over_p), "voxels": over_v,
            "points": over_p and not over_v, "masked": counts.sum() > 0,
            "boundaries": counts.sum() > 0}[case]
    if case == "fits":  # every valid point kept
        assert counts.sum() == mask.sum()
    if case == "boundaries":  # the divide by the voxel size would differ
        d = pts[..., :2] - np.float32(PCR[0:2])
        vs = np.float32(VS[:2])
        assert (np.floor(d / vs) != np.floor(d * (np.float32(1) / vs))).any()


@pytest.mark.parametrize("drop_order", ["first_come", "sorted"])
def test_stream_voxelizer_on_cell_boundaries_matches_jax(drop_order):
    """The stream voxelizer on the boundary cloud against the reference's
    as its models run it, compiled: XLA turns the divide by the voxel size
    into a product with the f32 reciprocal, which decides the cell of a
    point on a cell boundary."""
    pts, mask = _cloud("boundaries")
    ref = jax.device_get(jax.jit(lambda p, m: jvox.voxelize_stream_batch(
        p, m, VS, PCR, V, P, drop_order))(pts, mask))
    got = tvox.voxelize_stream_batch(torch.from_numpy(pts),
                                     torch.from_numpy(mask), VS, PCR, V, P,
                                     drop_order)
    for name in ("keep", "first", "last", "canvas_idx", "num_voxels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(got.feats.numpy(), ref.feats, rtol=0,
                               atol=1e-6)


def test_decorate_pillar_features_matches_jax():
    pts, mask = _cloud("points")
    vox = _j_voxelize(pts, mask)
    ref = np.asarray(jax.jit(lambda *a: jvox.decorate_pillar_features(
        *a, VS, PCR))(vox.voxels, vox.num_points, vox.coords))
    got = tvox.decorate_pillar_features(
        *(torch.from_numpy(a) for a in (
            vox.voxels, vox.num_points, vox.coords)), VS, PCR)
    assert got.shape == (2, V, P, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("filters", [(16,), (16, 16)], ids=["one", "two"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_padded_pfn_and_scatter_match_jax(filters, train):
    pts, mask = _cloud("points")
    vox = _j_voxelize(pts, mask)
    feats = jvox.decorate_pillar_features(
        jnp.asarray(vox.voxels), jnp.asarray(vox.num_points),
        jnp.asarray(vox.coords), VS, PCR)
    num_points = jnp.asarray(vox.num_points)
    jpfn = jpe.PillarFeatureNet(num_filters=filters)
    shapes = jax.eval_shape(lambda: jpfn.init(jax.random.PRNGKey(0), feats,
                                              num_points))
    variables = random_variables({k: dict(v) for k, v in shapes.items()},
                                 seed=7)
    out = jpfn.apply(variables, feats, num_points, train=train,
                     mutable=["batch_stats"] if train else False)
    ref, stats = out if train else (out, None)
    ref_canvas = jpe.PointPillarsScatter(ny=32, nx=32).apply(
        {}, ref, jnp.asarray(vox.coords))

    port = load_from_flax(PillarFeatureNet(9, filters), variables)
    port.train(train)
    tfeats = torch.from_numpy(np.array(feats))
    got = port(tfeats, torch.from_numpy(vox.num_points))
    canvas = scatter_voxel_canvas(got, torch.from_numpy(vox.coords), 32, 32)
    assert got.shape == (2, V, filters[-1])
    assert canvas.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(canvas.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_canvas), rtol=0, atol=1e-5)
    assert (np.asarray(ref)[vox.num_points > 0] > 0).mean() > 0.2
    if train:
        got_stats = load_from_flax(PillarFeatureNet(9, filters),
                                   {"params": variables["params"],
                                    "batch_stats": stats["batch_stats"]})
        for name, r in got_stats.named_buffers():
            np.testing.assert_allclose(dict(port.named_buffers())[name],
                                       r.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
        moved = [float((b - 1.0 if "var" in n else b).abs().max())
                 for n, b in port.named_buffers()]
        assert min(moved) > 0


def _occupied_coords(b, ny, nx, share, seed):
    """(b, V, 3) coords of ``share`` of the cells in first-come slots,
    -1 past each cloud's voxels."""
    rs = np.random.RandomState(seed)
    n = int(share * ny * nx)
    coords = np.full((b, n + 17, 3), -1, np.int32)
    for i in range(b):
        cells = rs.choice(ny * nx, n - 5 * i, replace=False)
        coords[i, :len(cells)] = np.stack(
            [np.zeros_like(cells), cells // nx, cells % nx], -1)
    return coords


def test_anchors_bev_area_mask_matches_jax():
    jm = JPP(**IRREGULAR)
    anchors = jm.anchor_set()["anchors"]
    bev = jbox.rbbox_to_near_bbox(anchors[:, jnp.array([0, 1, 3, 4, 6])])
    coords = _occupied_coords(2, 32, 32, 0.02, 3)
    ref = np.asarray(jax.jit(jax.vmap(lambda c: janchors.anchors_bev_area_mask(
        c, bev, (32, 32), VS, PCR, 1.0)))(jnp.asarray(coords)))
    got = tanchors.anchors_bev_area_mask(
        torch.from_numpy(coords), torch.from_numpy(np.array(bev)),
        (32, 32), VS, PCR, 1.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.1 < ref.mean() < 0.9


@pytest.mark.parametrize("config", [PP_CAR_CONFIG, PP_PED_CYCLE_CONFIG],
                         ids=["car", "ped_cycle"])
def test_generic_anchor_mask_equals_grid_mask(config):
    """At both KITTI configs the generic mask equals the grid one, and the
    grid one from coords equals the reference's ``mask_fn``."""
    model = PointPillars(**pointpillars_kwargs(pointpillars_config(config)))
    ny, nx = model.grid_ny, model.grid_nx
    coords = _occupied_coords(2, ny, nx, 0.01, 4)
    tc = torch.from_numpy(coords)
    got = model.anchor_mask_from_coords(tc)
    grid = model.area_mask.from_coords(tc)
    assert got.shape == (2, model.anchors.shape[0])
    assert torch.equal(got, grid)
    assert 0.05 < float(got.float().mean()) < 0.95
    feature_size, configs = model.anchor_layout()
    fn = janchors.make_grid_area_mask(
        (ny, nx), model.voxel_size, model.pc_range, feature_size,
        [janchors.ClassAnchorConfig(*c) for c in configs], 1.0)
    np.testing.assert_array_equal(grid[1].numpy(),
                                  np.asarray(fn(jnp.asarray(coords[1]))))


def _variables(jm, vox, seed):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(vox.voxels),
        jnp.asarray(vox.num_points), jnp.asarray(vox.coords)))
    return random_variables({"params": dict(shapes["params"]),
                             "batch_stats": dict(shapes["batch_stats"])},
                            seed=seed)


@pytest.fixture(scope="module")
def pp():
    """The tiny model's variables from ``init`` on voxels, a batch of
    voxels, anchors, the anchor mask and the reference's targets of a few
    car boxes."""
    from test_torch_pointpillars_train import GT_SLOTS, _gt_boxes

    jm = JPP(**TINY)
    pts, mask = _cloud("voxels", seed=1)
    vox = _j_voxelize(pts, mask)
    variables = _variables(jm, vox, seed=2)
    gen = jax.device_get(jm.anchor_set())
    # the targets of a few car boxes, the same on both sides (the
    # assignment and the mask are held to the reference elsewhere)
    tanch = torch.from_numpy(np.array(gen["anchors"]))
    amask = tanchors.anchors_bev_area_mask(
        torch.from_numpy(vox.coords), rbbox_to_near_bbox(tanch[:, BEV]),
        (32, 32), VS, PCR, 1.0)
    gt, gt_mask = _gt_boxes(2, np.random.RandomState(5))
    t = tanchors.assign_targets_batch(
        tanch, torch.from_numpy(gt),
        torch.ones(2, GT_SLOTS, dtype=torch.int32),
        torch.from_numpy(gt_mask),
        torch.from_numpy(np.array(gen["matched_threshold"])),
        torch.from_numpy(np.array(gen["unmatched_threshold"])), amask)
    t = {k: v.numpy() for k, v in t.items()}
    amask = amask.numpy()
    batch = {"voxels": vox.voxels, "num_points": vox.num_points,
             "coords": vox.coords, "anchors": gen["anchors"],
             "labels": t["labels"], "reg_targets": t["bbox_targets"]}
    return dict(jm=jm, variables=variables, pts=pts, mask=mask, vox=vox,
                amask=amask, batch=batch, gt=gt, gt_mask=gt_mask)


def _port(variables, config=TINY, dtype=torch.float32):
    from minddet_tpu_torch.utils.convert import pointpillars_from_flax

    model = pointpillars_from_flax(PointPillars(**config, dtype=dtype),
                                   variables)
    return model.eval().to(memory_format=torch.channels_last)


def _assert_detections(det, ref):
    np.testing.assert_array_equal(det["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(det["scores"].numpy(), ref["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy(), ref["boxes"], rtol=0,
                               atol=1e-4)
    kept = (ref["labels"] >= 0).sum(1)
    assert (kept > 3).all() and (kept < PREDICT["nms_post"]).all()


def test_voxel_predict_matches_jax(pp):
    jm, vox, b = pp["jm"], pp["vox"], pp["batch"]
    args = (vox.voxels, vox.num_points, vox.coords, b["anchors"], pp["amask"])
    ref = jax.device_get(jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.predict, **PREDICT))(
        pp["variables"], *(jnp.asarray(a) for a in args)))
    port = _port(pp["variables"])
    det = port.predict(*(torch.from_numpy(np.asarray(a)) for a in args),
                       **PREDICT)
    assert det["boxes"].shape == (2, 64, 7)
    _assert_detections(det, ref)
    # the same program from points: voxelize, the generic mask, predict
    got = port.predict_from_points_padded(
        torch.from_numpy(pp["pts"]), torch.from_numpy(pp["mask"]), **PREDICT)
    for k in ("boxes", "scores", "labels"):
        assert torch.equal(got[k], det[k]), k


def _jax_loss_and_grads(jm, variables, method, batch):
    def loss(params):
        out, state = jm.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              batch, train=True, method=method,
                              mutable=["batch_stats"])
        return out[0], (out[1], state)

    (total, (parts, state)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return jax.device_get((total, parts, state, grads))


def _assert_loss_and_grads(port, total, parts, state, grads, variables,
                           config, t_total, t_parts):
    np.testing.assert_allclose(float(t_total.detach()), float(total),
                               rtol=1e-6)
    for name in PARTS[1:]:
        np.testing.assert_allclose(float(t_parts[name].detach()),
                                   float(parts[name]),
                                   rtol=1e-6, err_msg=name)
        assert float(parts[name]) > 1e-3
    ref = _port({"params": grads, "batch_stats": state["batch_stats"]},
                config)
    got = dict(port.named_parameters())
    for name, g in ref.named_parameters():
        p = got[name]
        scale = float(g.abs().max())
        assert scale > 0, name
        err = float((p.grad.float() - g).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    bufs = dict(port.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


def test_voxel_loss_and_gradients_match_jax_f64(pp):
    """``loss`` on voxels with f64 compute over f32 parameters: the parts
    1e-6, every gradient within 1e-5 of its largest element, the BN
    statistics after the train-mode forward 1e-6."""
    with jax.enable_x64(True):
        jm = JPP(**TINY, dtype=jnp.float64)
        batch = {k: jnp.asarray(v) for k, v in pp["batch"].items()}
        total, parts, state, grads = _jax_loss_and_grads(
            jm, pp["variables"], jm.loss, batch)
    port = _port(pp["variables"], dtype=torch.float64).train()
    t_total, t_parts = port.loss({k: torch.from_numpy(np.asarray(v))
                                  for k, v in pp["batch"].items()})
    t_total.backward()
    _assert_loss_and_grads(port, total, parts, state, grads,
                           pp["variables"], TINY, t_total, t_parts)


def test_irregular_layout_predict_from_points_matches_jax(pp):
    """0.3 m anchors on 0.2 m cells: no grid mask, so ``predict_from_points``
    takes the dense branch on both sides (the same variables: the anchor
    layout has no parameters)."""
    jm = JPP(**IRREGULAR)
    port = _port(pp["variables"], IRREGULAR)
    assert port.area_mask is None
    ref = jax.device_get(jax.jit(lambda v, p, m: jm.apply(
        v, p, m, method=jm.predict_from_points, **PREDICT))(
        pp["variables"], jnp.asarray(pp["pts"]), jnp.asarray(pp["mask"])))
    det = port.predict_from_points(torch.from_numpy(pp["pts"]),
                                   torch.from_numpy(pp["mask"]), **PREDICT)
    _assert_detections(det, ref)


def test_irregular_layout_loss_from_gt_matches_jax_f64(pp):
    from test_torch_pointpillars_train import GT_SLOTS

    batch = {"points": pp["pts"], "points_mask": pp["mask"],
             "gt_boxes": pp["gt"].astype(np.float64),
             "gt_mask": pp["gt_mask"],
             "gt_classes": np.ones((2, GT_SLOTS), np.int32)}
    with jax.enable_x64(True):
        jm = JPP(**IRREGULAR, dtype=jnp.float64)
        gen = {k: np.asarray(v, np.float64)
               for k, v in jax.device_get(jm.anchor_set()).items()}
        jbatch = {k: jnp.asarray(v) for k, v in {**batch, **gen}.items()}
        total, parts, state, grads = _jax_loss_and_grads(
            jm, pp["variables"], jm.loss_from_gt, jbatch)
    port = _port(pp["variables"], IRREGULAR, torch.float64).train()
    tbatch = {k: torch.from_numpy(v) for k, v in {**batch, **gen}.items()}
    t_total, t_parts = port.loss_from_gt(tbatch)
    t_total.backward()
    _assert_loss_and_grads(port, total, parts, state, grads,
                           pp["variables"], IRREGULAR, t_total, t_parts)


def test_circle_nms_matches_jax():
    """Centres in a 10 m square, scores on a coarse grid (ties), radius
    1.5 m (no pair's distance within 1e-4 of it)."""
    rs = np.random.RandomState(8)
    centers = rs.uniform(0, 10, (2, 100, 2)).astype(np.float32)
    scores = np.round(rs.uniform(0, 1, (2, 100)), 1).astype(np.float32)
    idx, count, passes = circle_nms(torch.from_numpy(centers),
                                    torch.from_numpy(scores), 1.5, 0.05, 64)
    assert passes > 1 and idx.shape == (2, 64)
    ref_nms = jax.jit(j_circle_nms, static_argnums=(2, 3, 4))
    for i in range(2):
        d = np.sqrt(((centers[i, :, None] - centers[i, None]) ** 2).sum(-1))
        assert not (np.abs(d - 1.5) < 1e-4).any()
        ref_idx, ref_count = ref_nms(jnp.asarray(centers[i]),
                                     jnp.asarray(scores[i]), 1.5, 0.05, 64)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_idx))
        assert int(count[i]) == int(ref_count)
        assert 10 < int(ref_count) < 64


def test_stream_and_padded_canvas_equal_under_first_come(pp):
    """With the first-come drop order the stream path (running max at each
    pillar's last kept row, one scatter) and the padded path (the max over
    each voxel's slots, the voxel scatter) give the same canvas, here with
    both overflows (800 points, 256 voxels; clustered pillars over the
    cap)."""
    parts = [_cloud("points", seed=3), _cloud("voxels", seed=4)]
    pts = np.concatenate([p for p, _ in parts], 1)
    mask = np.concatenate([m for _, m in parts], 1)
    port = _port(pp["variables"], dict(TINY, voxel_drop_order="first_come"))
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.no_grad():
        stream, occ = port.canvas_from_points(tp, tm)
        vox = port.voxelize(tp, tm)
        feats = tvox.decorate_pillar_features(
            vox.voxels, vox.num_points, vox.coords, VS, PCR)
        padded = scatter_voxel_canvas(port.reader(feats, vox.num_points),
                                      vox.coords, 32, 32)
    assert int(vox.num_voxels.min()) == V and int(vox.num_points.max()) == P
    np.testing.assert_allclose(stream.numpy(), padded.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(occ, tanchors.occupancy_from_coords(vox.coords, 32,
                                                           32))


def test_voxel_entries_without_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entries run there")
    for entry in (pointpillars_voxel_entry, pointpillars_voxel_train_entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_voxel_entries_configuration_on_cpu():
    """The entries built (not run: full size) on the CPU when asked: the
    dense branch of the ped_cycle config, and the padded train step of
    ``pointpillars_train_entry``'s model and batch."""
    predict, (points, mask) = pointpillars_voxel_entry(
        device="cpu", batch=2, config=PP_PED_CYCLE_CONFIG)
    model = predict.__self__
    assert predict.__name__ == "predict_from_points_padded"
    assert model.anchors.shape == (293632, 7) and not model.training
    assert points.shape == (2, 18000, 4) and bool(mask.all())
    step, (state, batch) = pointpillars_voxel_train_entry(device="cpu",
                                                          batch=2)
    assert state.model.dtype == torch.bfloat16 and state.model.training
    assert batch["points"].shape == (2, 18000, 4)
    assert batch["gt_boxes"].shape == (2, 24, 7)
