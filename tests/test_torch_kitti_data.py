"""The port's KITTI data path vs the JAX package's, on the CPU.

- The parsers and frame conversions (``parse_label_file``,
  ``parse_calib_file``, ``camera_to_lidar_boxes``, ``read_velodyne``,
  ``lidar_box_to_camera``, ``camera_box_corners``,
  ``project_camera_to_image``, ``detections_to_kitti_annos``) on written
  label, calib and velodyne files, and ``kitti_examples`` /
  ``create_kitti_records`` on a written KITTI tree: equal.
- The host ops (the port's copy of the C++): ``rotated_iou_matrix`` at
  criteria -1 / 0 / 1, ``points_in_rboxes``, ``rotated_nms``, ``nms_2d``,
  bit for bit against ``minddet_tpu.ops.host_ops``; a source that does
  not compile raises (no fallback).
- ``noise_per_object``, ``global_augment``, ``build_gt_database`` +
  ``DataBaseSampler.sample`` and ``KittiDetection.__getitem__``, from the
  same seeds: arrays equal.
- ``kitti_batches`` at one loader thread against the reference's
  ``train/train.py:kitti_batches``: the same batches. Past one thread the
  batches depend on the thread schedule (one ``RandomState`` per dataset,
  shared by the loader's threads: a fault of the reference that the port
  keeps), so the comparison is at one.
- ``exponential_decay`` against optax's at counts 0, 27839, 27840, 55680:
  equal.
- ``synthetic_kitti_records``' frames; the KITTI entries' builds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.core.config import Config
from minddet_tpu.core.lr_schedules import exponential_decay as jax_exp_decay
from minddet_tpu.data import gt_sampler as jgs
from minddet_tpu.data import kitti as jk
from minddet_tpu.data.records import RecordDataset as JaxRecordDataset
from minddet_tpu.data.records import write_records
from minddet_tpu.ops import host_ops as jho
from minddet_tpu.train.train import kitti_batches as jax_kitti_batches
from minddet_tpu_torch import entry
from minddet_tpu_torch.core.lr_schedules import exponential_decay
from minddet_tpu_torch.data import gt_sampler as tgs
from minddet_tpu_torch.data import kitti as tk
from minddet_tpu_torch.data.kitti_eval import clean_gt
from minddet_tpu_torch.data.records import RecordDataset
from minddet_tpu_torch.ops import host_ops as tho
from minddet_tpu_torch.train.synthetic import (KITTI_P2, KITTI_POINTS,
                                               KITTI_TRV2C_RECT,
                                               kitti_batches,
                                               synthetic_kitti_records)

LABEL = (
    "Car 0.00 0 -1.57 614.24 181.78 727.31 284.77 1.57 1.73 4.15 1.00 1.75 "
    "13.22 -1.62\n"
    "Pedestrian 0.12 1 0.21 300.00 170.00 340.00 260.00 1.80 0.60 0.90 "
    "-4.10 1.70 9.80 0.35\n"
    "Van 0.30 2 1.10 900.00 150.00 1100.00 280.00 2.10 1.90 5.00 6.20 "
    "1.80 20.50 1.20\n"
    "DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 "
    "-1000 -10\n"
    "Truncated 0.00 0\n")
CALIB = (
    "P0: 700 0 600 0 0 700 180 0 0 0 1 0\n"
    "P2: 721.5377 0 609.5593 44.85728 0 721.5377 172.854 0.2163791 0 0 1 "
    "0.002745884\n"
    "R0_rect: 0.9999239 0.00983776 -0.007445048 -0.009869795 0.9999421 "
    "-0.004278459 0.007402527 0.004351614 0.9999631\n"
    "Tr_velo_to_cam: 0.007533745 -0.9999714 -0.000616602 -0.004069766 "
    "0.01480249 0.0007280733 -0.9998902 -0.07631618 0.9998621 0.00752379 "
    "0.01480755 -0.2717806\n")


def _assert_same(got, ref, exact=True):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_same(got[k], ref[k], exact)
        return
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r, exact)
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape
    if exact:
        np.testing.assert_array_equal(g, r)
    else:
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


def _kitti_tree(root, ids, rs):
    for d in ("label_2", "calib", "velodyne", "image_2"):
        os.makedirs(os.path.join(root, "training", d), exist_ok=True)
    for sid in ids:
        base = os.path.join(root, "training")
        with open(os.path.join(base, "label_2", f"{sid}.txt"), "w") as f:
            f.write(LABEL)
        with open(os.path.join(base, "calib", f"{sid}.txt"), "w") as f:
            f.write(CALIB)
        rs.randn(300, 4).astype(np.float32).tofile(
            os.path.join(base, "velodyne", f"{sid}.bin"))
    import cv2  # noqa: F401  (installed on the CPU host)

    cv2.imwrite(os.path.join(root, "training", "image_2", f"{ids[0]}.png"),
                np.zeros((370, 1224, 3), np.uint8))


def test_parsers_and_conversions_match_the_reference(tmp_path):
    label = tmp_path / "000001.txt"
    calib = tmp_path / "calib.txt"
    velo = tmp_path / "000001.bin"
    label.write_text(LABEL)
    calib.write_text(CALIB)
    np.random.RandomState(0).randn(100, 4).astype(np.float32).tofile(velo)
    objs_t, objs_j = tk.parse_label_file(str(label)), \
        jk.parse_label_file(str(label))
    assert len(objs_t) == 4 and objs_t[3]["name"] == "DontCare"
    _assert_same(objs_t, objs_j)
    cal_t, cal_j = tk.parse_calib_file(str(calib)), \
        jk.parse_calib_file(str(calib))
    _assert_same(cal_t, cal_j)
    _assert_same(tk.read_velodyne(str(velo)), jk.read_velodyne(str(velo)))
    boxes = tk.camera_to_lidar_boxes(objs_t[:3], cal_t)
    _assert_same(boxes, jk.camera_to_lidar_boxes(objs_j[:3], cal_j))
    _assert_same(tk.camera_to_lidar_boxes([], cal_t),
                 jk.camera_to_lidar_boxes([], cal_j))
    trv2c = cal_t["R0_rect"] @ cal_t["Tr_velo_to_cam"]
    cam = tk.lidar_box_to_camera(boxes, trv2c)
    _assert_same(cam, jk.lidar_box_to_camera(boxes, trv2c))
    corners = tk.camera_box_corners(cam)
    _assert_same(corners, jk.camera_box_corners(cam))
    _assert_same(tk.project_camera_to_image(corners, cal_t["P2"]),
                 jk.project_camera_to_image(corners, cal_t["P2"]))
    # the three objects, one behind the camera and one out of the image
    more = np.concatenate([boxes, [[-5.0, 0, -1.6, 1.8, 4.2, 1.5, 0.0],
                                   [8.0, -40.0, -1.6, 1.8, 4.2, 1.5, 0.3]]]
                          ).astype(np.float32)
    args = (more, np.array([0.9, 0.8, 0.7, 0.6, 0.5]),
            np.array([0, 1, 5, 0, 1]), ("Car", "Pedestrian"), trv2c,
            cal_t["P2"], (375, 1242))
    anno = tk.detections_to_kitti_annos(*args)
    assert len(anno["name"]) == 3 and anno["name"][2] == "Car"
    _assert_same(anno, jk.detections_to_kitti_annos(*args))


def test_examples_and_records_match_the_reference(tmp_path):
    ids = ["000000", "000007"]
    _kitti_tree(str(tmp_path), ids, np.random.RandomState(1))
    classes = ("Car", "Pedestrian")
    got = list(tk.kitti_examples(str(tmp_path), ids, classes))
    ref = list(jk.kitti_examples(str(tmp_path), ids, classes))
    _assert_same(got, ref)
    assert list(got[0]["img_shape"]) == [370, 1224]
    assert list(got[1]["img_shape"]) == [375, 1242]
    split = tmp_path / "train.txt"
    split.write_text("\n".join(ids) + "\n")
    paths = tk.create_kitti_records(str(tmp_path), str(split),
                                    str(tmp_path / "rec" / "train"), classes)
    back = RecordDataset(paths)
    ref_back = JaxRecordDataset(paths)
    assert len(back) == 2
    for i in range(2):
        _assert_same(back[i], ref_back[i])
        _assert_same(back[i], ref[i])


def _rboxes(rs, n, span=20.0):
    return np.stack([rs.uniform(-span, span, n), rs.uniform(-span, span, n),
                     rs.uniform(0.5, 5, n), rs.uniform(0.5, 5, n),
                     rs.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_host_rotated_iou_is_the_references_bit_for_bit(criterion):
    rs = np.random.RandomState(2)
    b1, b2 = _rboxes(rs, 120), _rboxes(rs, 90)
    b2[:10] = b1[:10]  # identical pairs
    b2[10:20, :2] = b1[10:20, :2] + 0.5 * (b1[10:20, 2:3] + b2[10:20, 2:3]) \
        * np.array([[1.0, 0.0]], np.float32)  # near-touching
    b2[20:25] = 0.0  # zero-size boxes
    got = tho.rotated_iou_matrix(b1, b2, criterion)
    ref = jho.rotated_iou_matrix(b1, b2, criterion)
    assert got.dtype == np.float32 and (got > 0).mean() > 0.01
    np.testing.assert_array_equal(got, ref)


def test_host_points_and_nms_are_the_references_bit_for_bit():
    rs = np.random.RandomState(3)
    boxes = _rboxes(rs, 150, span=10.0)
    points = rs.uniform(-12, 12, (4000, 3)).astype(np.float32)
    inside = tho.points_in_rboxes(points, boxes)
    assert inside.dtype == bool and inside.any()
    np.testing.assert_array_equal(inside, jho.points_in_rboxes(points,
                                                               boxes))
    scores = rs.rand(150).astype(np.float32)
    scores[5] = scores[6]  # a tie
    for kwargs in ({}, {"score_threshold": 0.3, "max_outputs": 20}):
        got = tho.rotated_nms(boxes, scores, 0.1, **kwargs)
        np.testing.assert_array_equal(got, jho.rotated_nms(boxes, scores,
                                                           0.1, **kwargs))
        xy = rs.uniform(0, 50, (150, 2)).astype(np.float32)
        xyxy = np.concatenate([xy, xy + rs.uniform(1, 20, (150, 2))],
                              1).astype(np.float32)
        got = tho.nms_2d(xyxy, scores, 0.5, **kwargs)
        np.testing.assert_array_equal(got, jho.nms_2d(xyxy, scores, 0.5,
                                                      **kwargs))
    assert tho.available()


def test_host_ops_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output:
    there is no fallback."""
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tho, "SOURCE", bad)
    monkeypatch.setattr(tho, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed for host_ops.cpp"):
        tho.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def _scene(rs, n_boxes=6, n_points=3000):
    """A cloud with car-sized boxes spread over 40 x 40 m, apart, and
    points inside each."""
    xy = np.stack(np.meshgrid(np.arange(3) * 12.0 - 12, np.arange(2) * 15.0
                              - 7), -1).reshape(-1, 2)[:n_boxes]
    boxes = np.concatenate([xy + rs.uniform(-1, 1, xy.shape),
                            np.full((n_boxes, 1), -1.6),
                            np.tile([[1.6, 3.9, 1.5]], (n_boxes, 1)),
                            rs.uniform(-np.pi, np.pi, (n_boxes, 1))], 1)
    pts = [np.stack([rs.uniform(-20, 20, n_points),
                     rs.uniform(-20, 20, n_points),
                     rs.uniform(-2, 0, n_points), rs.rand(n_points)], -1)]
    for b in boxes:
        u = rs.uniform(-0.5, 0.5, (40, 3))
        c, s = np.cos(b[6]), np.sin(b[6])
        pts.append(np.stack([b[0] + c * u[:, 0] * b[3] - s * u[:, 1] * b[4],
                             b[1] + s * u[:, 0] * b[3] + c * u[:, 1] * b[4],
                             b[2] + (u[:, 2] + 0.5) * b[5], rs.rand(40)],
                            -1))
    return (np.concatenate(pts).astype(np.float32),
            boxes.astype(np.float32))


def test_noise_per_object_matches_the_reference():
    points, boxes = _scene(np.random.RandomState(4))
    boxes[1, :2] = boxes[0, :2] + [1.0, 1.0]  # an overlapping pair
    valid = np.ones(len(boxes), bool)
    valid[4] = False
    kwargs = dict(rotation_perturb=(-0.15707963, 0.15707963),
                  center_noise_std=(0.25, 0.25, 0.25))
    got = tk.noise_per_object(np.random.RandomState(5), boxes, points,
                              valid, **kwargs)
    ref = jk.noise_per_object(np.random.RandomState(5), boxes, points,
                              valid, **kwargs)
    _assert_same(got, ref)
    assert not np.array_equal(got[1], boxes)  # some box moved
    np.testing.assert_array_equal(got[1][4], boxes[4])  # not valid


def test_global_augment_matches_the_reference():
    points, boxes = _scene(np.random.RandomState(6))
    for seed in range(4):  # flipped and not
        got = tk.global_augment(np.random.RandomState(seed), points, boxes)
        ref = jk.global_augment(np.random.RandomState(seed), points, boxes)
        _assert_same(got, ref)
    empty = np.zeros((0, 7), np.float32)
    _assert_same(tk.global_augment(np.random.RandomState(0), points, empty),
                 jk.global_augment(np.random.RandomState(0), points, empty))


def _records(n, classes=("Car",), seed=7):
    return synthetic_kitti_records(n, seed=seed, classes=classes)


def test_gt_database_and_sampler_match_the_reference():
    recs = _records(6, ("Car", "Pedestrian"))
    classes = ("Car", "Pedestrian")
    db_t = tgs.build_gt_database(tk.KittiDetection(recs), classes,
                                 min_points={"Car": 5, "Pedestrian": 10})
    db_j = jgs.build_gt_database(recs, classes,
                                 min_points={"Car": 5, "Pedestrian": 10})
    assert len(db_t["Car"]) > 5 and len(db_t["Pedestrian"]) > 2
    _assert_same(db_t, db_j)
    ids = {"Car": 1, "Pedestrian": 2}
    quota = {"Car": 15, "Pedestrian": 6}
    st = tgs.DataBaseSampler(db_t, quota, ids)
    sj = jgs.DataBaseSampler(db_j, quota, ids)
    for i, r in enumerate(recs):
        got = st.sample(np.random.RandomState(i), r["points"],
                        r["gt_boxes"], r["gt_classes"])
        ref = sj.sample(np.random.RandomState(i), r["points"],
                        r["gt_boxes"], r["gt_classes"])
        _assert_same(got, ref)
        assert len(got[1]) > len(r["gt_boxes"])


def test_gt_database_saves_and_loads(tmp_path):
    db = tgs.build_gt_database(_records(2), ("Car",))
    path = str(tmp_path / "db.pkl")
    tgs.save_database(db, path)
    _assert_same(tgs.load_database(path), jgs.load_database(path))
    _assert_same(tgs.load_database(path), db)


def _data_cfg(records, workers=1):
    return {"records": records, "classes": ["Car"], "max_points": 20000,
            "max_gt": 48, "gt_sampler": {"max_per_class": {"Car": 15}},
            "object_noise": {"rotation_perturb": [-0.15707963, 0.15707963],
                             "center_noise_std": [0.25, 0.25, 0.25]},
            "augment": True, "workers": workers}


def test_kitti_detection_matches_the_reference(tmp_path):
    recs = _records(5)
    pattern = write_records(str(tmp_path / "kitti"), recs)
    cfg = _data_cfg(recs)
    db = tgs.build_gt_database(tk.KittiDetection(recs), ("Car",))
    sampler_t = tgs.DataBaseSampler(db, {"Car": 15}, {"Car": 1})
    sampler_j = jgs.DataBaseSampler(db, {"Car": 15}, {"Car": 1})
    for kwargs in (dict(max_points=20000, max_gt=48,
                        object_noise=dict(cfg["object_noise"]),
                        augment=True),
                   dict(max_points=12000, max_gt=4, keep_raw=True)):
        got = tk.KittiDetection(recs, gt_sampler=sampler_t, seed=3,
                                **kwargs)
        ref = jk.KittiDetection(pattern[0], gt_sampler=sampler_j, seed=3,
                                **kwargs)
        assert len(got) == len(ref) == 5
        for i in (0, 3, 1, 4):
            _assert_same(got[i], ref[i])


def test_kitti_batches_match_the_reference_at_one_worker(tmp_path):
    recs = _records(8)
    paths = write_records(str(tmp_path / "train"), recs)
    got_it = kitti_batches({"data": _data_cfg(recs)}, 2, seed=1)
    ref_it = jax_kitti_batches(Config({"data": _data_cfg(
        str(tmp_path / "train-*.arrayrecord"))}), 2, seed=1)
    assert paths
    for _ in range(5):  # past an epoch of 4 batches
        got, ref = next(got_it), next(ref_it)
        assert int(got["step"]) == int(ref["step"])
        _assert_same(got, ref)
    assert got["gt_mask"].sum() > 2


def test_exponential_decay_matches_optax():
    jax_sched = jax_exp_decay(2e-4, 27840, 0.8)
    sched = exponential_decay(2e-4, 27840, 0.8)
    for count in (0, 27839, 27840, 55680):
        got = sched(torch.tensor(count))
        assert got.dtype == torch.float32
        ref = np.float32(jax_sched(jnp.asarray(count, jnp.int32)))
        assert float(got) == float(ref), count
    assert float(sched(torch.tensor(55680))) == pytest.approx(1.28e-4)


def test_synthetic_kitti_records():
    recs = _records(24, ("Cyclist", "Pedestrian"), seed=0)
    counts = [len(r["points"]) for r in recs]
    assert min(counts) >= KITTI_POINTS[0] and max(counts) < KITTI_POINTS[1]
    assert any(c > 20000 for c in counts) and any(c < 20000 for c in counts)
    pcr = entry.pointpillars_kwargs(entry.pointpillars_config(
        entry.PP_PED_CYCLE_CONFIG))["pc_range"]
    outside = [((r["points"][:, 0] < pcr[0]) | (r["points"][:, 0] > pcr[3])
                | (np.abs(r["points"][:, 1]) > pcr[4])).mean() for r in recs]
    assert min(outside) > 0.1
    names = np.concatenate([r["anno_name"] for r in recs])
    assert {"Car", "Van", "Pedestrian", "Cyclist", "DontCare"} <= set(names)
    for r in recs:
        n = len(r["anno_name"])
        assert all(len(r[k]) == n for k in r if k.startswith("anno_"))
        want = [{"Cyclist": 1, "Pedestrian": 2}[m] for m in r["anno_name"]
                if m in ("Cyclist", "Pedestrian")]
        np.testing.assert_array_equal(r["gt_classes"], want)
        inside = tho.points_in_rboxes(r["points"],
                                      r["gt_boxes"][:, [0, 1, 3, 4, 6]])
        assert (inside.sum(0) >= 20).all()
        dc = r["anno_name"] == "DontCare"
        assert (r["anno_location"][dc] == -1000).all()
        assert (r["anno_dimensions"][dc] == -1).all()
    annos = [{k[5:]: v for k, v in r.items() if k.startswith("anno_")}
             for r in recs]
    for cls in ("Car", "Pedestrian"):
        counted = [sum(clean_gt(a, cls, d)[2] for a in annos)
                   for d in (0, 1, 2)]
        assert 0 < counted[0] < counted[1] < counted[2], (cls, counted)
    again = _records(24, ("Cyclist", "Pedestrian"), seed=0)
    _assert_same(again, recs)
    np.testing.assert_array_equal(recs[0]["P2"], KITTI_P2)
    np.testing.assert_array_equal(recs[0]["Trv2c_rect"], KITTI_TRV2C_RECT)


def test_kitti_entries_build_on_cpu_when_asked():
    """The configs' models build (the full-width ones are for the card:
    no predict or step here)."""
    cfg = entry.pointpillars_config(entry.PP_PED_CYCLE_CONFIG)
    kw = entry.pointpillars_kwargs(cfg)
    assert kw["rpn_strides"] == (1, 2, 2) and kw["num_anchor_per_loc"] == 4
    model = entry.build_pointpillars("cpu", entry.PP_PED_CYCLE_CONFIG)
    assert model.anchors.shape == (293632, 7) and model.num_classes == 2
    assert model.feature_size == (248, 296) and not model.training
    thr = model.matched_threshold
    assert set(thr.tolist()) == {0.5}
    car = entry.build_pointpillars("cpu")
    default = entry.PointPillars().init_weights(
        torch.Generator().manual_seed(entry.SEED))
    for k, v in default.state_dict().items():
        assert torch.equal(car.state_dict()[k], v), k
    tx = entry.kitti_optimizer(cfg)
    assert tx.nan_guard and tx.weight_decay == 1e-4
    assert float(tx.learning_rate(torch.tensor(27840))) == pytest.approx(
        1.6e-4)
    with pytest.raises(ValueError, match="not ported"):
        entry.pointpillars_kwargs({"model": {"num_classes": 1,
                                             "rpn_stacked_params": True}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.pointpillars_kitti_train_entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.pointpillars_ped_cycle_entry()
