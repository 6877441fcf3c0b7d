"""The port's Waymo data path vs the JAX package's, on the CPU.

- ``convert_waymo_tfrecords`` on fake Frame protos (the fake toolkit of
  ``tests/test_waymo_path.py``, copied: TensorFlow and the Waymo toolkit
  are not installed), through ``sys.modules`` and through ``_modules``:
  the two packages write the same records; ``decode_waymo_frame`` and
  ``waymo_frame_to_example`` give the same records.
- ``WaymoDetection`` (with and without the GT sampler and the
  augmentation, the subsample, the lidar point counts) and
  ``waymo_batches`` at one loader thread, from the same seeds: arrays
  equal.
- Past one thread the batches depend on the thread schedule (one
  ``RandomState`` per dataset, shared by the loader's threads: a fault of
  the reference that the port keeps): pinned at four workers against one.
- ``synthetic_waymo_records``' frames.
- The Waymo geometry the port runs (``entry.waymo_config``: +-76.8 m,
  480 x 480): the model builds on the meta device in the port and through
  ``jax.eval_shape`` in the reference, with equal map shapes and parameter
  counts; every other key is the YAML's; the entries' settings.
"""

import contextlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kitti_data import _assert_same

from minddet_tpu.core.config import Config
from minddet_tpu.data import gt_sampler as jgs
from minddet_tpu.data import waymo as jw
from minddet_tpu.models.detectors.centerpoint import CenterPoint as JCP
from minddet_tpu.train.train import waymo_batches as jax_waymo_batches
from minddet_tpu_torch import entry
from minddet_tpu_torch.data import gt_sampler as tgs
from minddet_tpu_torch.data import waymo as tw
from minddet_tpu_torch.data.records import RecordDataset, write_records
from minddet_tpu_torch.ops import host_ops as tho
from minddet_tpu_torch.train.synthetic import (WAYMO_POINTS,
                                               synthetic_waymo_records,
                                               waymo_batches)

SMALL_POINTS = (3000, 5000)  # the tests' clouds: a random part of each
MAX_POINTS = 2500            # the dataset's subsample: every cloud has more


@contextlib.contextmanager
def _one_torch_thread():
    """One intra-op thread: the other test workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# -- the fake toolkit (a copy of tests/test_waymo_path.py's) -----------------

class _FakeBox:
    def __init__(self, cx, cy, cz, l, w, h, heading):
        self.center_x, self.center_y, self.center_z = cx, cy, cz
        self.length, self.width, self.height = l, w, h
        self.heading = heading


class _FakeLabel:
    def __init__(self, box, type_, npts):
        self.box = box
        self.type = type_
        self.num_lidar_points_in_box = npts


_FRAMES = {}


class _FakeFrame:
    def __init__(self):
        self.laser_labels = []

    def ParseFromString(self, data: bytes):
        spec = _FRAMES[data.decode()]
        self.laser_labels = [
            _FakeLabel(_FakeBox(*b["box"]), b["type"], b["npts"])
            for b in spec["labels"]]
        self._points = spec["points"]


class _FakeRecord:
    def __init__(self, key: str):
        self._key = key

    def numpy(self):
        return self._key.encode()


def _fake_modules():
    tf = types.ModuleType("tensorflow")
    tf.data = types.SimpleNamespace(
        TFRecordDataset=lambda path, compression_type="": [
            _FakeRecord(k) for k in _FRAMES if k.startswith(path)])
    wod = types.ModuleType("waymo_open_dataset")
    dataset_pb2 = types.ModuleType("waymo_open_dataset.dataset_pb2")
    dataset_pb2.Frame = _FakeFrame
    utils = types.ModuleType("waymo_open_dataset.utils")
    frame_utils = types.ModuleType("waymo_open_dataset.utils.frame_utils")
    frame_utils.parse_range_image_and_camera_projection = (
        lambda frame: (None, None, None))

    def _convert(frame, ri, cp, keep_polar_features=False):
        # the toolkit's polar layout: [range, intensity, elongation, x, y, z]
        assert keep_polar_features, "converter must request polar features"
        return [frame._points[:1000], frame._points[1000:]], None

    frame_utils.convert_range_image_to_point_cloud = _convert
    wod.dataset_pb2 = dataset_pb2
    wod.utils = utils
    utils.frame_utils = frame_utils
    return {"tensorflow": tf, "waymo_open_dataset": wod,
            "waymo_open_dataset.dataset_pb2": dataset_pb2,
            "waymo_open_dataset.utils": utils,
            "waymo_open_dataset.utils.frame_utils": frame_utils}


def _frame_spec(rng, n_pts=4000, n_obj=4, raw_types=False):
    labels = []
    for _ in range(n_obj):
        cx, cy = rng.uniform(-40, 40, 2)
        labels.append({
            "box": (cx, cy, 0.8, 4.5, 2.0, 1.7, rng.uniform(-np.pi, np.pi)),
            "type": int(rng.randint(1, 5)) if raw_types
            else int(rng.randint(1, 4)),
            "npts": int(rng.randint(1, 200))})
    xyz = np.stack([rng.uniform(-70, 70, n_pts), rng.uniform(-70, 70, n_pts),
                    rng.uniform(-1, 3, n_pts)], -1)
    intensity = rng.uniform(0, 1, (n_pts, 1))
    elongation = rng.uniform(0, 1, (n_pts, 1))
    rng_col = np.linalg.norm(xyz, axis=-1, keepdims=True)
    polar = np.concatenate([rng_col, intensity, elongation, xyz], -1)
    return {"points": polar.astype(np.float32), "labels": labels}


def _records_of(pattern):
    ds = RecordDataset(pattern)
    return [ds[i] for i in range(len(ds))]


def test_converter_matches_the_reference(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    _FRAMES.clear()
    for seg in ("segA", "segB"):
        for f in range(3):
            _FRAMES[f"{seg}/frame{f}"] = _frame_spec(rng, raw_types=True)
    spec = _frame_spec(rng, n_obj=5, raw_types=True)  # every raw type, and
    for i, t in enumerate((1, 2, 3, 4, 0)):           # an UNKNOWN
        spec["labels"][i]["type"] = t
    _FRAMES["segA/frame3"] = spec
    _FRAMES["segB/frame9"] = _frame_spec(rng, n_obj=0)  # no label
    mods = _fake_modules()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for max_points in (180000, 3000):
        got = tw.convert_waymo_tfrecords(
            ["segA", "segB"], str(tmp_path / f"t{max_points}"), max_points)
        ref = jw.convert_waymo_tfrecords(
            ["segA", "segB"], str(tmp_path / f"j{max_points}"), max_points)
        assert len(got) == len(ref) == 1
        recs = _records_of(got[0])
        _assert_same(recs, _records_of(ref[0]))
        assert len(recs) == 8
        assert recs[0]["points"].shape == (min(4000, max_points), 5)
    # SIGN and UNKNOWN dropped, CYCLIST compacted to 3; z-bottom boxes; the
    # polar features reordered to [x, y, z, intensity, elongation]
    assert list(recs[3]["gt_classes"]) == [1, 2, 3]
    np.testing.assert_allclose(recs[3]["gt_boxes"][:, 2], 0.8 - 1.7 / 2,
                               atol=1e-6)
    _assert_same(recs[0]["points"],
                 _FRAMES["segA/frame0"]["points"][:3000, [3, 4, 5, 1, 2]])
    assert recs[7]["gt_boxes"].shape == (0, 7)
    # the doubles injected instead of imported give the same records
    injected = tw.convert_waymo_tfrecords(
        ["segA", "segB"], str(tmp_path / "inj"), 3000, _modules={
            "tf": mods["tensorflow"],
            "dataset_pb2": mods["waymo_open_dataset.dataset_pb2"],
            "frame_utils": mods["waymo_open_dataset.utils.frame_utils"]})
    _assert_same(_records_of(injected[0]), recs)
    frame = _FakeFrame()
    frame.ParseFromString(b"segA/frame3")
    fu = mods["waymo_open_dataset.utils.frame_utils"]
    _assert_same(tw.decode_waymo_frame(frame, fu, 2500),
                 jw.decode_waymo_frame(frame, fu, 2500))


def test_converter_without_the_toolkit_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow and waymo_open"):
        tw.convert_waymo_tfrecords(["x"], "unused")


def test_frame_to_example_matches_the_reference():
    rs = np.random.RandomState(2)
    labels = [{"center": tuple(rs.uniform(-50, 50, 3)),
               "size": tuple(rs.uniform(0.5, 5, 3)),
               "heading": rs.uniform(-np.pi, np.pi), "type": t,
               "num_points": int(rs.randint(0, 300))}
              for t in (1, 2, 3, 1)]
    del labels[2]["num_points"]  # the default, 100
    pts = rs.randn(700, 5)
    for ls in (labels, []):
        got = tw.waymo_frame_to_example(pts, ls)
        _assert_same(got, jw.waymo_frame_to_example(pts, ls))
    assert got["gt_boxes"].shape == (0, 7)
    got = tw.waymo_frame_to_example(pts, labels)
    assert got["num_points_in_gt"][2] == 100
    np.testing.assert_allclose(got["gt_boxes"][:, 3:5],
                               np.array([lb["size"][1::-1] for lb in labels],
                                        np.float32))


# -- the dataset and its batches ---------------------------------------------

def small_records(n, seed=0, points=SMALL_POINTS):
    """``synthetic_waymo_records`` with each cloud cut to a random part of
    ``points`` (lo, hi) points (the clouds are shuffled): comparisons with
    the reference stay quick."""
    rs = np.random.RandomState(seed + 100)
    records = synthetic_waymo_records(n, seed=seed)
    for r in records:
        r["points"] = r["points"][:rs.randint(*points)].copy()
    return records


def _sampler_cfg():
    return {"max_per_class": {"VEHICLE": 15, "PEDESTRIAN": 10,
                              "CYCLIST": 10},
            "min_points": {c: 2 for c in tw.WAYMO_CLASSES}}


def _samplers(recs, path):
    min_points = _sampler_cfg()["min_points"]
    db = tgs.build_gt_database(tw.WaymoDetection(recs), tw.WAYMO_CLASSES,
                               min_points)
    _assert_same(db, jgs.build_gt_database(jw.WaymoDetection(path),
                                           jw.WAYMO_CLASSES, min_points))
    assert sum(len(v) for v in db.values()) > 20
    ids = {c: i + 1 for i, c in enumerate(tw.WAYMO_CLASSES)}
    per = _sampler_cfg()["max_per_class"]
    return tgs.DataBaseSampler(db, per, ids), jgs.DataBaseSampler(db, per,
                                                                  ids)


@pytest.mark.parametrize("sampled", [False, True])
def test_waymo_detection_matches_the_reference(tmp_path, sampled):
    recs = small_records(4)
    paths = write_records(str(tmp_path / "waymo"), recs)
    sampler_t, sampler_j = _samplers(recs, paths[0]) if sampled \
        else (None, None)
    for kwargs in (dict(max_points=MAX_POINTS, max_gt=80, augment=True),
                   dict(max_points=6000, max_gt=8)):
        got = tw.WaymoDetection(recs, gt_sampler=sampler_t, seed=3, **kwargs)
        ref = jw.WaymoDetection(paths[0], gt_sampler=sampler_j, seed=3,
                                **kwargs)
        assert len(got) == len(ref) == 4
        for i in (0, 3, 1, 2, 0):
            ex = got[i]
            _assert_same(ex, ref[i])
        assert ex["gt_boxes"].shape == (kwargs["max_gt"], 9)
        n_rec = len(recs[0]["gt_classes"])
        if sampled and kwargs["max_gt"] == 80:
            assert ex["gt_mask"].sum() > n_rec  # objects were pasted
            assert (ex["gt_num_points"][n_rec:] == 100).all()
        if not kwargs.get("augment"):  # z-centre, zero velocity
            g = min(n_rec, 8)
            b7 = recs[0]["gt_boxes"][:g]
            np.testing.assert_allclose(ex["gt_boxes"][:g, 2],
                                       b7[:, 2] + b7[:, 5] / 2, rtol=1e-6)
            assert (ex["gt_boxes"][:, 6:8] == 0).all()
            _assert_same(ex["gt_num_points"][:g],
                         recs[0]["num_points_in_gt"][:g])


def _data_cfg(records, workers=1, sampled=True):
    cfg = {"records": records, "max_points": MAX_POINTS, "max_gt": 96,
           "augment": True, "workers": workers}
    if sampled:
        cfg["gt_sampler"] = _sampler_cfg()
    return cfg


@pytest.mark.parametrize("sampled", [False, True])
def test_waymo_batches_match_the_reference_at_one_worker(tmp_path, sampled):
    recs = small_records(4, seed=1)
    write_records(str(tmp_path / "train"), recs)
    got_it = waymo_batches({"data": _data_cfg(recs, sampled=sampled)}, 2,
                           seed=1)
    ref_it = jax_waymo_batches(Config({"data": _data_cfg(
        str(tmp_path / "train-*.arrayrecord"), sampled=sampled)}), 2, seed=1)
    for _ in range(4):  # two epochs
        got, ref = next(got_it), next(ref_it)
        assert int(got["step"]) == int(ref["step"])
        _assert_same(got, ref)
    assert set(got) == {"points", "points_mask", "gt_boxes", "gt_classes",
                        "gt_mask", "step"}
    assert got["gt_mask"].sum() > 20


def test_waymo_batches_depend_on_the_thread_schedule():
    """The reference's fault, kept: one ``RandomState`` per dataset. An
    example's draws depend on what was drawn before it, so the loader's
    threads, which draw in the order they run, change the batches."""
    recs = small_records(8, seed=2)
    ds = tw.WaymoDetection(recs, max_points=MAX_POINTS, max_gt=96,
                           augment=True, seed=0)
    first = ds[1]
    ds = tw.WaymoDetection(recs, max_points=MAX_POINTS, max_gt=96,
                           augment=True, seed=0)
    ds[0]
    assert not np.array_equal(ds[1]["points"], first["points"])
    one = waymo_batches({"data": _data_cfg(recs, workers=1)}, 2, seed=0)
    four = waymo_batches({"data": _data_cfg(recs, workers=4)}, 2, seed=0)
    diff = []
    for _ in range(8):
        a, b = next(one), next(four)
        diff.append(float(np.abs(a["points"] - b["points"]).max()))
    assert max(diff) > 1.0, diff


def test_synthetic_waymo_records():
    recs = synthetic_waymo_records(3, seed=0)
    classes = np.concatenate([r["gt_classes"] for r in recs])
    assert set(classes) == {1, 2, 3}
    counts = np.concatenate([r["num_points_in_gt"] for r in recs])
    assert 0 < (counts <= 5).mean() < 0.5 and counts.max() > 100
    for r in recs:
        p, b = r["points"], r["gt_boxes"]
        assert p.dtype == np.float32 and p.shape[1] == 5
        assert WAYMO_POINTS[0] <= len(p) < WAYMO_POINTS[1]
        assert (p[:, 3:] >= 0).all() and (p[:, 3:] <= 1).all()
        assert np.hypot(p[:, 0], p[:, 1]).max() < 80
        assert b.dtype == np.float32 and b.shape[1] == 7
        assert (np.abs(b[:, 2]) < 0.06).all()  # on the road, z-bottom
        # the counts are the frame's points inside each box
        inside = tho.points_in_rboxes(p[:, :2], b[:, [0, 1, 3, 4, 6]])
        inside &= (p[:, 2:3] >= b[:, 2]) & (p[:, 2:3] <= b[:, 2] + b[:, 5])
        _assert_same(inside.sum(0).astype(np.int32), r["num_points_in_gt"])
    _assert_same(synthetic_waymo_records(3, seed=0), recs)


# -- the geometry and the entries ---------------------------------------------

def test_waymo_geometry_builds_in_both_packages():
    """At +-76.8 m and 480 x 480 the Waymo model builds in the reference
    (``jax.eval_shape``: nothing computed) and in the port (the meta
    device), with the same maps and parameter counts; the reference's
    predict gives (1, 83, 9) boxes. Every key but the range and the grid is
    the YAML's."""
    yaml = entry.read_config(entry.CP_WAYMO_CONFIG)
    cfg = entry.waymo_config()
    assert {k: v for k, v in cfg.items() if k != "model"} == {
        k: v for k, v in yaml.items() if k != "model"}
    changed = {k for k in yaml["model"]
               if cfg["model"][k] != yaml["model"][k]}
    assert changed == {"pc_range", "grid_ny", "grid_nx"}
    m = cfg["model"]
    assert set(m) == set(yaml["model"])
    assert m["pc_range"] == [-76.8, -76.8, -2.0, 76.8, 76.8, 4.0]
    assert m["grid_ny"] == m["grid_nx"] == 480 == round(
        (m["pc_range"][3] - m["pc_range"][0]) / m["voxel_size"][0])
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in m.items() if k != "type"}
    jm = JCP(**kwargs)
    vox = ((1, 32, 20, 5), (1, 32), (1, 32, 3))
    jmaps, shapes = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros(vox[0]),
        jnp.zeros(vox[1], jnp.int32), jnp.zeros(vox[2], jnp.int32)))
    pts, pmask = jnp.zeros((1, 64, 5)), jnp.ones((1, 64), bool)
    det = jax.eval_shape(lambda v: jm.apply(v, pts, pmask,
                                            method=jm.predict_from_points),
                         shapes)
    assert det["boxes"].shape == (1, 83, 9)
    model = entry.build_centerpoint("cpu", cfg).to("meta")
    assert (model.grid_ny, model.task_num_classes) == (480, (3,))
    maps = model.forward_voxels(*[
        torch.zeros(s, dtype=d, device="meta") for s, d in zip(
            vox, (torch.float32, torch.int32, torch.int32))])
    assert [{k: tuple(v.shape) for k, v in t.items()} for t in maps] == [
        {k: tuple(v.shape) for k, v in t.items()} for t in jmaps]
    assert maps[0]["hm"].shape == (1, 120, 120, 3)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    two = entry.waymo_config(two_stage=True)["model"]
    assert two["type"] == "CenterPointTwoStage"
    assert (two["num_proposals"], two["fg_iou"], two["refine_hidden"]) == (
        128, 0.55, 128)
    assert {k: v for k, v in two.items() if k not in entry.TWO_STAGE_KEYS} \
        == {k: v for k, v in m.items() if k != "type"}
    with _one_torch_thread():
        refined = entry.build_centerpoint("cpu", entry.waymo_config(True))
    assert type(refined).__name__ == "CenterPointTwoStage"
    assert refined.grid_ny == 480 and refined.num_proposals == 128


def test_waymo_entries_settings():
    """The optimizer, schedule, batch and data keys of the config's train
    section as the entries take them (the full-width model is for the
    card: no predict or step here)."""
    cfg = entry.waymo_config()
    tx = entry.nuscenes_optimizer(cfg)
    assert tx.nan_guard and tx.weight_decay == 0.01
    assert tx.clip_global_norm == 35.0
    assert float(tx.learning_rate(torch.tensor(112000))) == pytest.approx(
        3e-3)
    assert float(tx.learning_rate(torch.tensor(0))) == pytest.approx(3e-4)
    assert int(cfg["train"]["batch_size"]) == 4
    data = cfg["data"]
    assert (data["type"], data["num_features"], data["max_points"],
            data["max_gt"], data["augment"], data["workers"]) == (
        "waymo", 5, 160000, 200, True, 4)
    assert data["gt_sampler"]["max_per_class"] == {
        "VEHICLE": 15, "PEDESTRIAN": 10, "CYCLIST": 10}
    assert set(entry.WAYMO_ROUTES) == {"plain", "refined"}
    with pytest.raises(ValueError, match="route must be one of"):
        entry.centerpoint_waymo_eval_entry("cpu", route="tta")
    if not torch.cuda.is_available():
        for fn in (entry.centerpoint_waymo_entry,
                   entry.centerpoint_waymo_train_entry,
                   entry.centerpoint_waymo_eval_entry):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
    with _one_torch_thread():
        predict, (points, mask) = entry.centerpoint_waymo_entry("cpu")
    assert predict.__name__ == "predict_from_points"
    assert type(predict.__self__).__name__ == "CenterPoint"
    assert not predict.__self__.training
    assert points.shape == (1, 160000, 5) and bool(mask.all())
