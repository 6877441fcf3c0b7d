"""The port's KITTI evaluator and the KITTI train step's optimizer vs the
JAX package's, on the CPU.

- ``rotated_iou_3d`` unbatched and batched (the reference under
  ``jax.vmap``): within 1e-5.
- ``calculate_overlaps`` for bbox / bev / 3d on seeded annos (DontCare
  rows at location -1000 with dimensions -1, images with no GT or no
  detection, chunks of 3 images): within 1e-5.
- ``get_official_eval_result`` on seeded fixtures (Car, Pedestrian,
  Cyclist, all three difficulties, DontCare regions, Van as Car's similar
  class, AOS): every table entry within 1e-6.
- ``kitti_evaluate`` end to end on the tiny PointPillars of
  ``tests/test_3d_data.py:269-334`` (grid 32 x 32), weights carried across
  with ``pointpillars_from_flax``, GT annos made from part of the model's
  own detections so that the table is not all zeros: the same detections
  (as sets, by box: 1e-4) and the same table (1e-6).
- One step of ``entry.kitti_optimizer`` (the ped_cycle config's AdamW with
  decay 1e-4 under ``exponential_decay``, the NaN guard) on a tiny
  ped_cycle-shaped model (2 classes, ``rpn_strides`` (1, 2, 2), 4 anchors
  per cell) fed one ``kitti_batches`` batch, f64 parameters and compute,
  against the reference's ``build_optimizer`` + ``build_schedule``: the
  loss parts and grad_norm 1e-6, the parameters after the step 1e-6 where
  the gradient resolves the element (Adam's first step is ~lr * sign(g)
  elsewhere) and 1e-10 where it is above 1e-3 of the tensor's largest,
  which sees the decoupled decay (lr * wd * p = 2e-8 * p).

The reference's CPU ``rotated_iou_bev`` is its XLA form, which the port
does not copy: it errs on some nearly antiparallel pairs (``ROADMAP.md``
§3). The fixtures' detections keep their GT's heading within 0.2 rad and
false positives lie metres away from any GT, so no fixture meets that
case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables

from minddet_tpu.core.lr_schedules import build_schedule
from minddet_tpu.core.optim import build_optimizer
from minddet_tpu.data import kitti_eval as jke
from minddet_tpu.data.records import write_records
from minddet_tpu.models.detectors import pointpillars as jpp
from minddet_tpu.ops import rotated_iou as jri
from minddet_tpu.train import evaluate as jev
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch import entry
from minddet_tpu_torch.data import kitti_eval as tke
from minddet_tpu_torch.data.kitti import detections_to_kitti_annos
from minddet_tpu_torch.models.detectors.pointpillars import PointPillars
from minddet_tpu_torch.ops import rotated_iou as tri
from minddet_tpu_torch.train import evaluate as tev
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import (KITTI_P2, KITTI_TRV2C_RECT,
                                               kitti_batches,
                                               synthetic_kitti_records)
from minddet_tpu_torch.utils.convert import (adamw_state_from_optax,
                                             pointpillars_from_flax)

CLASSES = ("Car", "Pedestrian", "Cyclist")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes7(rs, n, near=None):
    """KITTI lidar boxes [x, y, z, w, l, h, yaw]; with ``near`` each a
    jittered copy of near[i] (heading within 0.2 rad, some lifted out of
    its height range)."""
    if near is None:
        return np.stack([rs.uniform(0, 50, n), rs.uniform(-20, 20, n),
                         rs.uniform(-2, -1.4, n),
                         1.6 * rs.uniform(0.8, 1.2, n),
                         3.9 * rs.uniform(0.8, 1.2, n),
                         1.5 * rs.uniform(0.8, 1.2, n),
                         rs.uniform(-np.pi, np.pi, n)], -1).astype(
            np.float32)
    out = near[rs.randint(0, len(near), n)].copy()
    out[:, :2] += rs.uniform(-1.5, 1.5, (n, 2))
    out[:, 2] += np.where(rs.rand(n) < 0.2, 3.0, rs.uniform(-0.5, 0.5, n))
    out[:, 3:6] *= rs.uniform(0.8, 1.25, (n, 3))
    out[:, 6] += rs.uniform(-0.2, 0.2, n)
    return out


def test_rotated_iou_3d_matches_the_reference():
    rs = np.random.RandomState(0)
    a = _boxes7(rs, 40)
    b = _boxes7(rs, 30, near=a)
    b[:5] = a[:5]  # identical
    ref = np.asarray(jax.jit(jri.rotated_iou_3d)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    got = tri.rotated_iou_3d(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (40, 30) and got.dtype == torch.float32
    assert (ref > 0.1).sum() > 20 and (ref == 0).sum() > 100
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # batched: (B, N, 7) x (B, M, 7), the reference under vmap
    ab = np.stack([a, _boxes7(rs, 40)])
    bb = np.stack([b, _boxes7(rs, 30, near=ab[1])])
    ref = np.asarray(jax.jit(jax.vmap(jri.rotated_iou_3d))(
        jnp.asarray(ab), jnp.asarray(bb)))
    got = tri.rotated_iou_3d(torch.from_numpy(ab), torch.from_numpy(bb))
    assert got.shape == (2, 40, 30)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _dt_annos(rs, gt_annos):
    """Detections from the GT annos: most GT objects (not DontCare) once,
    jittered in the camera frame (location +-0.4 m, sizes +-15 %, heading
    +-0.2 rad, image box +-6 px, alpha +-0.3), some twice, a few renamed;
    false positives 5-8 m to the side at the same heading; scores
    uniform."""
    out = []
    for g in gt_annos:
        real = np.nonzero(g["name"] != "DontCare")[0]
        take = real[rs.rand(len(real)) < 0.85]
        take = np.concatenate([take, take[rs.rand(len(take)) < 0.2]])
        fp = real[rs.rand(len(real)) < 0.3]
        src = np.concatenate([take, fp]).astype(int)
        n = len(src)
        names = g["name"][src].astype("U16")
        flip = rs.rand(n) < 0.08
        names[flip] = rs.choice(CLASSES, int(flip.sum()))
        loc = g["location"][src] + rs.uniform(-0.4, 0.4, (n, 3))
        loc[len(take):, 0] += rs.choice([-1, 1], len(fp)) * rs.uniform(
            5, 8, len(fp))
        bbox = g["bbox"][src] + rs.uniform(-6, 6, (n, 4))
        bbox[len(take):, 0::2] += rs.uniform(-300, 300, (len(fp), 1))
        out.append({
            "name": names, "bbox": bbox.astype(np.float32),
            "location": loc.astype(np.float32),
            "dimensions": (g["dimensions"][src] * rs.uniform(
                0.85, 1.15, (n, 3))).astype(np.float32),
            "rotation_y": (g["rotation_y"][src] + rs.uniform(-0.2, 0.2, n)
                           ).astype(np.float32),
            "alpha": (g["alpha"][src] + rs.uniform(-0.3, 0.3, n)).astype(
                np.float32),
            "score": rs.uniform(0.05, 1.0, n).astype(np.float32),
            "occluded": np.zeros(n, np.int64),
            "truncated": np.zeros(n, np.float32)})
    return out


def _fixture(frames=12, seed=3):
    recs = synthetic_kitti_records(frames, seed=seed, classes=CLASSES)
    gt = [{k[5:]: v for k, v in r.items() if k.startswith("anno_")}
          for r in recs]
    gt[2] = {k: v[:0] for k, v in gt[2].items()}  # a frame with no label
    dt = _dt_annos(np.random.RandomState(seed + 1), gt)
    dt[4] = {k: v[:0] for k, v in dt[4].items()}  # one with no detection
    return gt, dt


@pytest.mark.parametrize("metric", ["bbox", "bev", "3d"])
def test_calculate_overlaps_match_the_reference(metric):
    gt, dt = _fixture()
    assert any((g["name"] == "DontCare").any() for g in gt)
    ref = jke.calculate_overlaps(gt, dt, metric, chunk=5)
    got = tke.calculate_overlaps(gt, dt, metric, chunk=5)
    assert len(got) == len(ref) == len(gt)
    hits = 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
        hits += int((r > 0.5).sum())
    assert hits > 20
    if metric != "bbox":  # DontCare rows lie 1000 m off, sizes -1
        dc = [(o, a["name"] == "DontCare") for o, a in zip(got, gt)]
        assert all((o[m] == 0).all() for o, m in dc)


def test_official_eval_result_matches_the_reference():
    gt, dt = _fixture()
    names = np.concatenate([g["name"] for g in gt])
    assert {"Car", "Van", "Pedestrian", "Cyclist", "DontCare"} <= set(names)
    kwargs = dict(classes=CLASSES, compute_aos=True)
    ref = jke.get_official_eval_result(gt, dt, **kwargs)
    timings = {}
    got = tke.get_official_eval_result(gt, dt, timings=timings, **kwargs)
    assert set(timings) == {"overlaps", "evaluate"}
    assert got.keys() == ref.keys()
    nonzero = 0
    for cls in CLASSES:
        assert set(got[cls]) == {"bbox", "bev", "3d", "aos"}
        for metric, aps in ref[cls].items():
            np.testing.assert_allclose(got[cls][metric], aps, rtol=0,
                                       atol=1e-6, err_msg=(cls, metric))
            nonzero += sum(a > 1 for a in aps)
    assert nonzero >= 20
    # only bev, no AOS, and one difficulty's pieces
    ref = jke.get_official_eval_result(gt, dt, ("Pedestrian",), ("bev",))
    got = tke.get_official_eval_result(gt, dt, ("Pedestrian",), ("bev",))
    np.testing.assert_allclose(got["Pedestrian"]["bev"],
                               ref["Pedestrian"]["bev"], rtol=0, atol=1e-6)
    for d in (0, 1, 2):
        ig_t = tke.clean_gt(gt[0], "Car", d)
        ig_j = jke.clean_gt(gt[0], "Car", d)
        np.testing.assert_array_equal(ig_t[0], ig_j[0])
        assert ig_t[2] == ig_j[2]
        np.testing.assert_array_equal(tke.clean_dt(dt[0], "Car", d),
                                      jke.clean_dt(dt[0], "Car", d))
    ov = tke.calculate_overlaps(gt[:1], dt[:1], "bbox")[0]
    ig, dc, _ = tke.clean_gt(gt[0], "Car", 1)
    idt = tke.clean_dt(dt[0], "Car", 1)
    for t in (0.2, 0.6):
        got = tke._image_statistics(ov, gt[0], dt[0], ig, idt, dc, 0.7, t,
                                    True)
        ref = jke._image_statistics(ov, gt[0], dt[0], ig, idt, dc, 0.7, t,
                                    True)
        assert got[:4] == ref[:4]
        np.testing.assert_array_equal(got[4], ref[4])
    scores = np.random.RandomState(0).rand(50)
    np.testing.assert_array_equal(tke._ap_thresholds(scores, 60),
                                  jke._ap_thresholds(scores, 60))
    np.testing.assert_array_equal(tke._dc_iod_max(dt[0]["bbox"], dc),
                                  jke._dc_iod_max(dt[0]["bbox"], dc))


TINY_VS, TINY_PCR = (0.2, 0.2, 4.0), (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
TINY_EVAL = dict(num_classes=1, grid_ny=32, grid_nx=32, voxel_size=TINY_VS,
                 pc_range=TINY_PCR, rpn_filters=(32, 64, 128),
                 rpn_up_filters=(32, 32, 32),
                 anchor_sizes=((1.6, 3.9, 1.56),),
                 anchor_strides=((0.4, 0.4, 0.0),),
                 anchor_offsets=((0.2, -3.0, -1.78),), max_voxels=256,
                 max_points_per_voxel=8)


def _tiny_frames(rs, n):
    frames = []
    for _ in range(n):
        pts = np.stack([rs.uniform(0.2, 6.2, 500), rs.uniform(-3, 3, 500),
                        rs.uniform(-2.5, 0.5, 500), rs.uniform(0, 1, 500)],
                       -1).astype(np.float32)
        frames.append({"points": pts, "gt_boxes": np.zeros((0, 7),
                                                           np.float32),
                       "gt_classes": np.zeros(0, np.int32), "P2": KITTI_P2,
                       "Trv2c_rect": KITTI_TRV2C_RECT,
                       "img_shape": np.array([375, 1242], np.int32)})
    return frames


def _gt_from_detections(det, frames, rs):
    """Per frame, GT annos from up to 3 of the detections above 0.3 (kept
    ones made a Van or given occlusion / truncation at random) and a
    DontCare row: a table with entries above 0."""
    for i, f in enumerate(frames):
        keep = np.nonzero(det["scores"][i] > 0.3)[0][:3]
        a = detections_to_kitti_annos(
            det["boxes"][i][keep], np.ones(len(keep)),
            np.zeros(len(keep), int), ("Car",), KITTI_TRV2C_RECT, KITTI_P2,
            (375, 1242))
        n = len(a["name"])
        names = np.where(rs.rand(n) < 0.2, "Van", "Car")
        f.update({
            "anno_name": np.array(list(names) + ["DontCare"], dtype="U16"),
            "anno_bbox": np.concatenate([a["bbox"], [[10, 150, 60, 190]]]
                                        ).astype(np.float32),
            "anno_alpha": np.append(a["alpha"], -10).astype(np.float32),
            "anno_occluded": np.append(rs.randint(0, 3, n), -1),
            "anno_truncated": np.append(
                np.where(rs.rand(n) < 0.7, 0, 0.4), -1).astype(np.float32),
            "anno_location": np.concatenate(
                [a["location"], [[-1000] * 3]]).astype(np.float32),
            "anno_dimensions": np.concatenate(
                [a["dimensions"], [[-1] * 3]]).astype(np.float32),
            "anno_rotation_y": np.append(a["rotation_y"], -10).astype(
                np.float32)})
    return frames


def _capture(monkeypatch, module, name):
    seen = {}
    inner = getattr(module, name)

    def wrapped(gt_annos, dt_annos, **kwargs):
        seen.update(gt=gt_annos, dt=dt_annos)
        return inner(gt_annos, dt_annos, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_kitti_evaluate_matches_the_reference(tmp_path, monkeypatch):
    rs = np.random.RandomState(0)
    frames = _tiny_frames(rs, 4)
    jm = jpp.PointPillars(**TINY_EVAL)
    pts0 = jnp.zeros((1, 500, 4))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts0, jnp.ones((1, 500), bool),
        method=jm.predict_from_points))
    variables = random_variables({"params": dict(shapes["params"]),
                                  "batch_stats": dict(shapes[
                                      "batch_stats"])}, seed=1)
    port = pointpillars_from_flax(PointPillars(**TINY_EVAL).eval(),
                                  variables)
    # the top 64 candidates' NMS keeps what the protocol's NMS (over all
    # 512 anchors) keeps among them: a subset of its detections, cheaply
    det = port.predict_from_points(
        torch.from_numpy(np.stack([f["points"] for f in frames])),
        torch.ones(len(frames), 500, dtype=torch.bool), nms_pre=64)
    det = {k: v.numpy() for k, v in det.items() if k != "nms_passes"}
    frames = _gt_from_detections(det, frames, rs)
    write_records(str(tmp_path / "kitti"), frames)

    seen_j = _capture(monkeypatch, jke, "get_official_eval_result")
    seen_t = _capture(monkeypatch, tev, "get_official_eval_result")
    ref = jev.kitti_evaluate(jm, variables,
                             str(tmp_path / "kitti-*.arrayrecord"))
    timings = {}
    got = tev.kitti_evaluate(port, frames, timings=timings)
    assert set(timings) == {"load", "copy", "predict", "annos", "overlaps",
                            "evaluate"}
    assert len(seen_t["dt"]) == len(seen_j["dt"]) == 4
    for g, r in zip(seen_t["dt"], seen_j["dt"]):
        assert len(g["name"]) == len(r["name"]) > 0
        order = [int(np.argmin(np.abs(r["location"] - loc).sum(1)))
                 for loc in g["location"]]
        assert sorted(order) == list(range(len(order)))
        for k in ("bbox", "location", "dimensions", "rotation_y", "alpha",
                  "score"):
            np.testing.assert_allclose(g[k], r[k][order], rtol=1e-5, atol=1e-4,
                                       err_msg=k)
    assert set(got["Car"]) == {"bbox", "bev", "3d", "aos"}
    for metric, aps in ref["Car"].items():
        np.testing.assert_allclose(got["Car"][metric], aps, rtol=0,
                                   atol=1e-6, err_msg=metric)
    assert max(got["Car"]["3d"]) > 10
    # the CLI's --max-images: the first 3 frames only, on both sides
    ref = jev.kitti_evaluate(jm, variables,
                             str(tmp_path / "kitti-*.arrayrecord"),
                             max_frames=3)
    got = tev.kitti_evaluate(port, frames, max_frames=3)
    assert len(seen_t["dt"]) == len(seen_j["dt"]) == 3
    for metric, aps in ref["Car"].items():
        np.testing.assert_allclose(got["Car"][metric], aps, rtol=0,
                                   atol=1e-6, err_msg=metric)


TINY_PED = dict(num_classes=2, grid_ny=32, grid_nx=32,
                voxel_size=(0.2, 0.2, 3.0), pc_range=(0.0, -3.2, -2.5, 6.4,
                                                      3.2, 0.5),
                rpn_layer_nums=(1, 1, 1), rpn_strides=(1, 2, 2),
                rpn_filters=(16, 32, 64), rpn_up_filters=(16, 16, 16),
                num_anchor_per_loc=4,
                anchor_sizes=((0.6, 1.76, 1.73), (0.6, 0.8, 1.73)),
                anchor_strides=((0.2, 0.2, 0.0), (0.2, 0.2, 0.0)),
                anchor_offsets=((0.1, -3.1, -1.465), (0.1, -3.1, -1.2)),
                matched_thresholds=(0.5, 0.5),
                unmatched_thresholds=(0.35, 0.35), max_voxels=256,
                max_points_per_voxel=8)
PED_CLASSES = ("Cyclist", "Pedestrian")
PARTS = ("loc_loss", "cls_loss", "dir_loss")


def _ped_records(rs, n):
    """Frames over the tiny range with 2-4 cyclists and pedestrians, apart,
    points inside each."""
    recs = []
    sizes = {1: (0.6, 1.76, 1.73), 2: (0.6, 0.8, 1.73)}
    for _ in range(n):
        k = rs.randint(2, 5)
        cls = rs.randint(1, 3, k)
        xy = np.stack([0.8 + 1.5 * np.arange(k) + rs.uniform(-0.2, 0.2, k),
                       rs.uniform(-2.4, 2.4, k)], -1)
        boxes = np.concatenate([xy, np.full((k, 1), -1.6),
                                np.array([sizes[c] for c in cls]),
                                rs.uniform(-np.pi, np.pi, (k, 1))], 1)
        pts = [np.stack([rs.uniform(0, 6.4, 400), rs.uniform(-3.2, 3.2, 400),
                         rs.uniform(-2.5, 0.5, 400), rs.rand(400)], -1)]
        for b in boxes:
            u = rs.uniform(-0.4, 0.4, (30, 3))
            pts.append(np.stack([b[0] + u[:, 0] * b[3], b[1] + u[:, 1]
                                 * b[4], b[2] + (u[:, 2] + 0.5) * b[5],
                                 rs.rand(30)], -1))
        recs.append({"points": np.concatenate(pts).astype(np.float32),
                     "gt_boxes": boxes.astype(np.float32),
                     "gt_classes": cls.astype(np.int32)})
    return recs


def test_kitti_optimizer_step_matches_the_reference():
    cfg = entry.pointpillars_config(entry.PP_PED_CYCLE_CONFIG)
    tcfg = cfg["train"]
    data = {"records": _ped_records(np.random.RandomState(2), 6),
            "classes": list(PED_CLASSES), "max_points": 500, "max_gt": 12,
            "gt_sampler": {"max_per_class": {"Cyclist": 3,
                                             "Pedestrian": 3}},
            "object_noise": dict(cfg["data"]["object_noise"]),
            "augment": True, "workers": 1}
    raw = next(kitti_batches({"data": data}, 2, seed=0))
    assert raw["gt_mask"].sum() >= 6
    assert set(np.unique(raw["gt_classes"][raw["gt_mask"]])) == {1, 2}
    batch = {k: raw[k] for k in entry.KITTI_BATCH_KEYS}
    batch["gt_boxes"] = batch["gt_boxes"].astype(np.float64)
    with jax.enable_x64(True):
        jm = jpp.PointPillars(**TINY_PED, dtype=jnp.float64)
        gen = {k: np.array(v, np.float64)
               for k, v in jm.anchor_set().items()}
        batch.update(gen)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
            jnp.asarray(batch["points_mask"]),
            method=jm.predict_from_points))
        variables = jax.tree.map(lambda a: a.astype(np.float64),
                                 random_variables(
            {"params": dict(shapes["params"]),
             "batch_stats": dict(shapes["batch_stats"])}, seed=3))
        tx = build_optimizer(dict(tcfg["optimizer"]),
                             build_schedule(dict(tcfg["lr_schedule"])))

        def loss_apply(v, b, train=True):
            return jm.apply(v, b, train=train, method=jm.loss_from_gt,
                            mutable=["batch_stats"])

        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert gen["anchors"].shape == (32 * 32 * 4, 7)

    model = pointpillars_from_flax(PointPillars(
        **TINY_PED, dtype=torch.float64).double(), variables)
    model = model.to(memory_format=torch.channels_last)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    recipe = entry.kitti_optimizer(cfg)
    state = TrainState.create(model, recipe)
    state, metrics = make_train_step(entry.model_gt_loss)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("loss", "grad_norm") + PARTS:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)
    assert all(float(jmetrics[k]) > 1e-3 for k in PARTS)
    ref = pointpillars_from_flax(PointPillars(
        **TINY_PED, dtype=torch.float64).double(),
                                 {"params": new_jstate.params,
                                  "batch_stats": new_jstate.batch_stats})
    opt = recipe.init(ref)
    adamw_state_from_optax(ref, opt, new_jstate.opt_state)
    got = dict(model.named_parameters())
    # the decoupled decay moves a parameter by lr * wd * p (2e-8 * p): the
    # f64 comparison at 1e-10 sees it where |p| > 5e-3, on the elements
    # whose gradient is large enough (1e-3 of the tensor's max) that the
    # f32 losses' rounding moves Adam's step, lr * g / (|g| + eps), by
    # less than that
    decay = (float(tcfg["lr_schedule"]["learning_rate"])
             * float(tcfg["optimizer"]["weight_decay"]))
    atol = 1e-10
    seen = tight_total = 0
    unresolved = 0
    for name, r in ref.named_parameters():
        g_ref = opt.state[r]["exp_avg"] / (1 - 0.9)
        scale = float(g_ref.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name].grad.numpy(), g_ref.numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
        assert (r.detach() - old[name]).abs().max() > 1e-5, name
        clear = (g_ref.abs() > 1e-5 * scale) & (g_ref.abs() > 1e-6)
        unresolved += int((~clear).sum())
        np.testing.assert_allclose(got[name].detach()[clear].numpy(),
                                   r.detach()[clear].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        tight = g_ref.abs() > 1e-3 * scale
        np.testing.assert_allclose(got[name].detach()[tight].numpy(),
                                   r.detach()[tight].numpy(), rtol=0,
                                   atol=atol, err_msg=name)
        seen += int((decay * old[name][tight].abs() > 10 * atol).sum())
        tight_total += int(tight.sum())
    assert unresolved < 2e-2 * sum(p.numel() for p in got.values())
    assert tight_total > 0.9 * sum(p.numel() for p in got.values())
    assert seen > 0.2 * tight_total
    assert int(state.optimizer.param_groups[0]["count"]) == 1
