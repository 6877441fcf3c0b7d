"""The port's nuScenes data path vs the JAX package's, on the CPU.

- ``one_cycle`` and ``one_cycle_momentum`` at steps 0, up_steps - 1,
  up_steps, up_steps + 1 and total_steps (and past it), the config's
  140000 steps and short schedules: within one f32 ulp (the learning rate
  is equal at every step checked).
- The quaternion helpers, ``infer_attributes``, ``create_nuscenes_infos``,
  ``load_merged_sweeps`` and ``create_nuscenes_records`` (the records and
  the CBGS sidecar) on the fake v1.0 tree of ``test_nuscenes_data.py``:
  equal.
- ``cbgs_indices``, ``global_augment_3d`` on boxes with nonzero velocity,
  ``NuScenesDetection`` (CBGS, with and without the GT sampler, the
  augmentation, the subsample, the tracking keys) and ``nuscenes_batches``
  at one loader thread, from the same seeds: arrays equal.
- Past one thread the batches depend on the thread schedule (one
  ``RandomState`` per dataset, shared by the loader's threads: a fault of
  the reference that the port keeps): pinned at four workers against one.
- ``synthetic_nuscenes_records``' keyframes and the nuScenes entries'
  builds.
"""

import numpy as np
import pytest
import torch
from test_nuscenes_data import _write_fake_nusc
from test_torch_kitti_data import _assert_same

from minddet_tpu.core.config import Config
from minddet_tpu.core.lr_schedules import one_cycle as jax_one_cycle
from minddet_tpu.core.lr_schedules import (
    one_cycle_momentum as jax_one_cycle_momentum)
from minddet_tpu.data import gt_sampler as jgs
from minddet_tpu.data import nuscenes as jn
from minddet_tpu.train.train import nuscenes_batches as jax_nuscenes_batches
from minddet_tpu_torch import entry
from minddet_tpu_torch.core.lr_schedules import one_cycle, one_cycle_momentum
from minddet_tpu_torch.data import gt_sampler as tgs
from minddet_tpu_torch.data import nuscenes as tn
from minddet_tpu_torch.data.records import write_records
from minddet_tpu_torch.ops import host_ops as tho
from minddet_tpu_torch.train.synthetic import (NUSC_RANGE, nuscenes_batches,
                                               synthetic_nuscenes_records)

SMALL_POINTS = (3000, 5000)  # the tests' clouds: a random part of each
MAX_POINTS = 2500            # the dataset's subsample: every cloud has more


def _ulps(a, b) -> int:
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("total", [140000, 10, 7, 1])
def test_one_cycle_matches_the_reference(total):
    up = int(total * 0.4)
    steps = sorted({0, max(up - 1, 0), up, up + 1, total, total + 3,
                    total // 2})
    lr, jlr = one_cycle(2e-3, total), jax_one_cycle(2e-3, total)
    mom, jmom = one_cycle_momentum(total), jax_one_cycle_momentum(total)
    for s in steps:
        got = lr(torch.tensor(s))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), jlr(s)) == 0, s
        assert _ulps(mom(torch.tensor(s)).numpy(), jmom(s)) <= 1, s
    assert float(lr(torch.tensor(up))) == pytest.approx(2e-3)
    assert float(lr(torch.tensor(0))) == pytest.approx(2e-4 if up else 2e-3)
    assert float(lr(torch.tensor(total))) == pytest.approx(2e-8)
    assert float(mom(torch.tensor(0))) == pytest.approx(0.95 if up else 0.85)


def test_quaternion_helpers_and_attributes_match_the_reference():
    rs = np.random.RandomState(0)
    for _ in range(20):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        p = rs.randn(4)
        p /= np.linalg.norm(p)
        t = rs.randn(3) * 10
        for fn in ("quat_to_rot", "quat_inverse", "quaternion_yaw"):
            _assert_same(np.asarray(getattr(tn, fn)(q)),
                         np.asarray(getattr(jn, fn)(q)))
        _assert_same(tn.quat_multiply(q, p), jn.quat_multiply(q, p))
        for inverse in (False, True):
            _assert_same(tn.transform_matrix(t, q, inverse),
                         jn.transform_matrix(t, q, inverse))
    boxes = rs.randn(40, 9).astype(np.float32)
    boxes[::3, 6:8] = 0.1
    ids = rs.randint(-1, 12, 40)
    _assert_same(tn.infer_attributes(boxes, ids),
                 jn.infer_attributes(boxes, ids))
    assert (tn.infer_attributes(boxes, ids) >= 0).sum() > 10


def test_infos_sweeps_and_records_match_the_reference(tmp_path):
    root = _write_fake_nusc(str(tmp_path))
    for nsweeps in (1, 3, 10):
        for val in (None, {"scene-0001"}):
            got = tn.create_nuscenes_infos(root, "v1.0-test", nsweeps,
                                           val_scene_names=val)
            ref = jn.create_nuscenes_infos(root, "v1.0-test", nsweeps,
                                           val_scene_names=val)
            _assert_same(got, ref)
        infos = got[1]
        assert len(infos) == 3 and len(infos[2]["sweeps"]) == nsweeps - 1
        for info in infos:
            _assert_same(tn.load_merged_sweeps(info, root, nsweeps),
                         jn.load_merged_sweeps(info, root, nsweeps))
    assert infos[2]["gt_boxes"][1, 7] == pytest.approx(3.0)  # walking +y
    got = tn.create_nuscenes_records(root, str(tmp_path / "t"), "v1.0-test",
                                     nsweeps=3)
    ref = jn.create_nuscenes_records(root, str(tmp_path / "j"), "v1.0-test",
                                     nsweeps=3)
    assert len(got) == len(ref) == 1
    with open(str(tmp_path / "t-classsets.json")) as f, \
            open(str(tmp_path / "j-classsets.json")) as g:
        assert f.read() == g.read()
    recs_t = tn.NuScenesDetection(str(tmp_path / "t-*.arrayrecord")).records
    recs_j = jn.NuScenesDetection(str(tmp_path / "j-*.arrayrecord")).records
    _assert_same([recs_t[i] for i in range(3)],
                 [recs_j[i] for i in range(3)])
    assert set(recs_t[0]) == {"points", "gt_boxes", "gt_classes", "gt_attrs",
                              "token", "scene", "timestamp",
                              "global_from_lidar", "gt_track_ids"}
    # CBGS from the sidecar, and from a scan of the same records in memory
    for cbgs_src in (str(tmp_path / "t-*.arrayrecord"),
                     [recs_t[i] for i in range(3)]):
        got = tn.NuScenesDetection(cbgs_src, max_points=256, cbgs=True,
                                   augment=True, seed=2)
        ref = jn.NuScenesDetection(str(tmp_path / "j-*.arrayrecord"),
                                   max_points=256, cbgs=True, augment=True,
                                   seed=2)
        assert len(got) == len(ref) >= 2
        for i in range(len(ref)):
            _assert_same(got[i], ref[i])


def test_cbgs_indices_match_the_reference():
    rs = np.random.RandomState(1)
    sets = [{c for c in tn.DETECTION_CLASSES if rs.rand() < p}
            for p in rs.uniform(0.02, 0.6, 60)]
    for seed in (0, 5):
        got = tn.cbgs_indices(sets, rng=np.random.RandomState(seed))
        ref = jn.cbgs_indices(sets, rng=np.random.RandomState(seed))
        _assert_same(got, ref)
    _assert_same(tn.cbgs_indices([set(), set()]),
                 jn.cbgs_indices([set(), set()]))
    counts = {c: sum(c in sets[i] for i in got)
              for c in tn.DETECTION_CLASSES}
    rare = min(tn.DETECTION_CLASSES, key=lambda c: sum(c in s for s in sets))
    assert counts[rare] > sum(rare in s for s in sets)


def test_global_augment_3d_matches_the_reference():
    rs = np.random.RandomState(4)
    points = rs.uniform(-50, 50, (500, 5)).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-40, 40, (6, 3)),
                            rs.uniform(0.5, 5, (6, 3)),
                            rs.uniform(-8, 8, (6, 2)),
                            rs.uniform(-np.pi, np.pi, (6, 1))], 1
                           ).astype(np.float32)
    flips = set()
    for seed in range(8):
        got = tn.global_augment_3d(np.random.RandomState(seed), points, boxes)
        ref = jn.global_augment_3d(np.random.RandomState(seed), points, boxes)
        _assert_same(got, ref)
        speed = np.linalg.norm(got[1][:, 6:8], axis=1)
        np.testing.assert_allclose(speed / np.linalg.norm(boxes[:, 6:8],
                                                          axis=1),
                                   speed[0] / np.linalg.norm(boxes[0, 6:8]),
                                   rtol=1e-5)
        flips.add(tuple(np.sign(got[1][0, 6:8] * boxes[0, 6:8]) < 0))
    assert len(flips) > 1  # velocity components flipped by some draws
    empty = tn.global_augment_3d(np.random.RandomState(0), points,
                                 np.zeros((0, 9), np.float32))
    _assert_same(empty, jn.global_augment_3d(np.random.RandomState(0),
                                             points,
                                             np.zeros((0, 9), np.float32)))


def small_records(n, seed=0, scenes=2, points=SMALL_POINTS):
    """``synthetic_nuscenes_records`` with each merged cloud cut to a
    random part of ``points`` (lo, hi) points (the clouds are shuffled):
    comparisons with the reference stay quick, and away from f32 rounding
    of the many-point pillars."""
    rs = np.random.RandomState(seed + 100)
    records = synthetic_nuscenes_records(n, seed=seed, scenes=scenes)
    for r in records:
        r["points"] = r["points"][:rs.randint(*points)].copy()
    return records


def _records(n, seed=0, scenes=2):
    return small_records(n, seed, scenes)


def _sampler_cfg():
    return {"max_per_class": {"car": 2, "truck": 3, "bus": 4,
                              "pedestrian": 2, "barrier": 2,
                              "traffic_cone": 2, "bicycle": 6},
            "min_points": {c: 5 for c in tn.DETECTION_CLASSES}}


@pytest.mark.parametrize("sampled", [False, True])
def test_nuscenes_detection_matches_the_reference(tmp_path, sampled):
    recs = _records(4)
    paths = write_records(str(tmp_path / "nusc"), recs)
    sampler_t = sampler_j = None
    if sampled:
        min_points = _sampler_cfg()["min_points"]
        db = tgs.build_gt_database(tn.NuScenesDetection(recs),
                                   tn.DETECTION_CLASSES, min_points)
        _assert_same(db, jgs.build_gt_database(
            jn.NuScenesDetection(paths[0]), jn.DETECTION_CLASSES,
            min_points))
        assert sum(len(v) for v in db.values()) > 20
        ids = {c: i + 1 for i, c in enumerate(tn.DETECTION_CLASSES)}
        sampler_t = tgs.DataBaseSampler(db, _sampler_cfg()["max_per_class"],
                                        ids)
        sampler_j = jgs.DataBaseSampler(db, _sampler_cfg()["max_per_class"],
                                        ids)
    for kwargs in (dict(max_points=MAX_POINTS, max_gt=80, cbgs=True,
                        augment=True),
                   dict(max_points=6000, max_gt=8)):
        got = tn.NuScenesDetection(recs, gt_sampler=sampler_t, seed=3,
                                   **kwargs)
        ref = jn.NuScenesDetection(paths[0], gt_sampler=sampler_j, seed=3,
                                   **kwargs)
        assert len(got) == len(ref)
        for i in (0, 3, 1, len(ref) - 1, 2):
            ex = got[i]
            _assert_same(ex, ref[i])
            assert set(tn.TRACKING_KEYS) <= set(ex)
        if sampled and kwargs["max_gt"] == 80:
            n_rec = len(recs[int(got._indices[2])]["gt_classes"])
            assert ex["gt_mask"].sum() > n_rec  # objects were pasted
            assert (ex["gt_attrs"][n_rec:] == -1).all()
            assert (ex["gt_track_ids"][n_rec:] == -1).all()


def _data_cfg(records, workers=1, sampled=True):
    cfg = {"records": records, "max_points": MAX_POINTS, "max_gt": 96,
           "cbgs": True, "augment": True, "workers": workers}
    if sampled:
        cfg["gt_sampler"] = _sampler_cfg()
    return cfg


@pytest.mark.parametrize("sampled", [False, True])
def test_nuscenes_batches_match_the_reference_at_one_worker(tmp_path,
                                                             sampled):
    recs = _records(4)
    write_records(str(tmp_path / "train"), recs)
    got_it = nuscenes_batches({"data": _data_cfg(recs, sampled=sampled)}, 2,
                              seed=1)
    ref_it = jax_nuscenes_batches(Config({"data": _data_cfg(
        str(tmp_path / "train-*.arrayrecord"), sampled=sampled)}), 2, seed=1)
    for _ in range(4):
        got, ref = next(got_it), next(ref_it)
        assert int(got["step"]) == int(ref["step"])
        _assert_same(got, ref)
    assert set(got) == {"points", "points_mask", "gt_boxes", "gt_classes",
                        "gt_mask", "step"}
    assert got["gt_mask"].sum() > 20


def test_nuscenes_batches_depend_on_the_thread_schedule():
    """The reference's fault, kept: one ``RandomState`` per dataset. An
    example's draws depend on what was drawn before it, so the loader's
    threads, which draw in the order they run, change the batches."""
    recs = _records(4)
    ds = tn.NuScenesDetection(recs, max_points=MAX_POINTS, max_gt=96,
                              augment=True, seed=0)
    first = ds[1]
    ds = tn.NuScenesDetection(recs, max_points=MAX_POINTS, max_gt=96,
                              augment=True, seed=0)
    ds[0]
    assert not np.array_equal(ds[1]["points"], first["points"])
    one = nuscenes_batches({"data": _data_cfg(recs, workers=1)}, 2, seed=0)
    four = nuscenes_batches({"data": _data_cfg(recs, workers=4)}, 2, seed=0)
    diff = []
    for _ in range(6):
        a, b = next(one), next(four)
        diff.append(float(np.abs(a["points"] - b["points"]).max()))
    assert max(diff) > 1.0, diff


def test_synthetic_nuscenes_records():
    recs = synthetic_nuscenes_records(6, seed=0, scenes=2)
    counts = [len(r["points"]) for r in recs]
    assert min(counts) >= 200000 and max(counts) < 280000
    assert recs[0]["points"].shape[1] == 5 and recs[0]["points"].dtype == \
        np.float32
    lags = np.unique(recs[0]["points"][:, 4])
    np.testing.assert_allclose(lags, 0.05 * np.arange(10), atol=1e-6)
    classes = np.concatenate([r["gt_classes"] for r in recs])
    assert set(classes) <= set(range(1, 11)) and len(set(classes)) >= 8
    for r in recs:
        b = r["gt_boxes"]
        assert b.shape[1] == 9 and b.dtype == np.float32
        assert (np.hypot(b[:, 0], b[:, 1]) < NUSC_RANGE).all()
        _assert_same(r["gt_attrs"], tn.infer_attributes(b, r["gt_classes"]))
        inside = tho.points_in_rboxes(r["points"][:, :2],
                                      b[:, [0, 1, 3, 4, 8]])
        near = np.hypot(b[:, 0], b[:, 1]) < 30
        assert (inside.sum(0)[near] >= 5).all()
        assert len(np.unique(r["gt_track_ids"])) == len(b)
    assert (np.abs(np.concatenate([r["gt_boxes"][:, 6:8] for r in recs]))
            > 0.3).any()
    # an object keeps its track id, and moves by its velocity in the
    # global frame from one keyframe to the next
    a, b = recs[0], recs[1]
    assert bytes(a["scene"]) == bytes(b["scene"]) != bytes(recs[3]["scene"])
    assert b["timestamp"] - a["timestamp"] == pytest.approx(0.5)
    common = np.intersect1d(a["gt_track_ids"], b["gt_track_ids"])
    assert len(common) > 20
    for tid in common[:10]:
        ia = int(np.nonzero(a["gt_track_ids"] == tid)[0][0])
        ib = int(np.nonzero(b["gt_track_ids"] == tid)[0][0])
        ga = a["global_from_lidar"].astype(np.float64)
        gb = b["global_from_lidar"].astype(np.float64)
        pa = ga[:3, :3] @ a["gt_boxes"][ia, :3] + ga[:3, 3]
        pb = gb[:3, :3] @ b["gt_boxes"][ib, :3] + gb[:3, 3]
        va = ga[:2, :2] @ a["gt_boxes"][ia, 6:8]
        np.testing.assert_allclose(pb[:2] - pa[:2], 0.5 * va, atol=2e-3)
    again = synthetic_nuscenes_records(6, seed=0, scenes=2)
    _assert_same(again, recs)


def test_nuscenes_entries_build_on_cpu_when_asked():
    """The optimizer of the config's train section and the entries'
    settings (the full-width models are for the card: no predict or step
    here)."""
    cfg = entry.read_config(entry.CP_CONFIG)
    tx = entry.nuscenes_optimizer(cfg)
    assert tx.nan_guard and tx.weight_decay == 0.01
    assert tx.clip_global_norm == 35.0
    assert float(tx.learning_rate(torch.tensor(56000))) == pytest.approx(
        2e-3)
    assert int(cfg["train"]["batch_size"]) == 4
    with pytest.raises(ValueError, match="not a CenterPoint nuScenes"):
        entry.nuscenes_optimizer(entry.pointpillars_config())
    with pytest.raises(ValueError, match="route must be one of"):
        entry.centerpoint_nusc_eval_entry("cpu", route="double")
    if not torch.cuda.is_available():
        for fn in (entry.centerpoint_nusc_train_entry,
                   entry.centerpoint_nusc_tracking_entry):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
