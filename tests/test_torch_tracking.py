"""The port's greedy tracker, the tracking protocol and the tracking
evaluation vs the JAX package's, on the CPU.

- ``GreedyTracker`` frame by frame and ``track_sequence`` on the cases of
  ``tests/test_tracking.py`` (constant velocity, a head-on crossing, an
  occlusion within ``max_age``, an expiry past it, class gating) and on
  seeded scenes with dropped and false detections, scores on a coarse
  grid (ties, taken in the stable ``mergesort`` order), every gate form
  (the default table, a number, a table) and two ``max_age``: the track
  ids equal exactly.
- ``evaluate_tracking`` on that file's goldens (a perfect track, an id
  switch, the recall sweep, the range filter and its missing-``ego``
  error, mismatched frame counts) and on the seeded scenes' tracks: every
  entry within 1e-12.
- ``tracking_scenes`` fed the GT as detections: AMOTA 1.
- ``nuscenes_tracking_evaluate`` end to end on the tiny CenterPoint of
  ``test_torch_nuscenes_eval.py``: the same detections (by box), the same
  track ids on them, and the same metrics (1e-6).
"""

import numpy as np
import pytest
import torch
from test_torch_centerpoint_train import _one_torch_thread
from test_torch_nuscenes_eval import tiny  # noqa: F401  (a fixture)
from test_tracking import CLASSES, _frame

from minddet_tpu import track as jtr
from minddet_tpu.data import nuscenes_track_eval as jte
from minddet_tpu.train import evaluate as jev
from minddet_tpu_torch import track as ttr
from minddet_tpu_torch.data import nuscenes_track_eval as tte
from minddet_tpu_torch.data.nuscenes import DETECTION_CLASSES
from minddet_tpu_torch.train import evaluate as tev


def _scripted(name):
    """The cases of ``tests/test_tracking.py`` as per-frame (centers,
    velocities, classes, scores, time lag)."""
    frames = []
    if name == "constant_velocity":
        for t in range(5):
            frames.append(([[5.0 * t, 0.0], [0.0, 20.0]],
                           [[10.0, 0.0], [0.0, 0.0]], [0, 1], [0.9, 0.8],
                           0.0 if t == 0 else 0.5))
    elif name == "crossing":
        for t in range(6):
            x = 4.0 * t
            frames.append(([[-10.0 + x, 0.0], [10.0 - x, 0.4]],
                           [[8.0, 0.0], [-8.0, 0.0]], [0, 0], [0.9, 0.85],
                           0.0 if t == 0 else 0.5))
    elif name in ("occlusion", "expiry"):
        gap = 2 if name == "occlusion" else 5
        for t in range(8):
            seen = not 2 <= t < 2 + gap
            c = [[2.0 * t, 0.0]] if seen else np.zeros((0, 2))
            v = [[4.0, 0.0]] if seen else np.zeros((0, 2))
            frames.append((c, v, [0] * seen, [0.9] * seen, 0.5 * (t > 0)))
    elif name == "class_gating":
        frames = [([[0.0, 0.0]], [[0.0, 0.0]], [0], [0.9], 0.0),
                  ([[0.1, 0.0]], [[0.0, 0.0]], [1], [0.9], 0.5),
                  ([[0.2, 0.0], [0.0, 0.1]], [[0.0, 0.0]] * 2, [0, 1],
                   [0.5, 0.5], 0.5)]
    return frames


def _scene(rs, n_frames=10, n_objects=12, classes=7):
    """A seeded scene: objects at constant velocity, per frame each
    detected with probability 0.85 (centre +-0.3 m, velocity +-0.5 m/s), a
    few false detections, scores on a 0.05 grid (ties)."""
    c0 = rs.uniform(-40, 40, (n_objects, 2))
    vel = rs.uniform(-8, 8, (n_objects, 2)) * (rs.rand(n_objects, 1) < 0.7)
    cls = rs.randint(0, classes, n_objects)
    gt, det = [], []
    for t in range(n_frames):
        c = c0 + vel * 0.5 * t
        gt.append((c, cls, np.arange(n_objects)))
        seen = rs.rand(n_objects) < 0.85
        k = rs.randint(0, 4)
        dc = np.concatenate([c[seen] + rs.uniform(-0.3, 0.3, (seen.sum(), 2)),
                             rs.uniform(-45, 45, (k, 2))])
        dv = np.concatenate([vel[seen] + rs.uniform(-0.5, 0.5,
                                                    (seen.sum(), 2)),
                             rs.uniform(-3, 3, (k, 2))])
        dcls = np.concatenate([cls[seen], rs.randint(0, classes, k)])
        sc = np.round(rs.uniform(0.1, 1.0, len(dcls)) / 0.05) * 0.05
        order = rs.permutation(len(dcls))
        det.append((dc[order], dv[order], dcls[order], sc[order],
                    0.5 * (t > 0)))
    return gt, det


def _both(frames, **kwargs):
    names = kwargs.pop("class_names", DETECTION_CLASSES)
    got = ttr.GreedyTracker(class_names=names, **kwargs)
    ref = jtr.GreedyTracker(class_names=names, **kwargs)
    out = []
    for c, v, k, s, lag in frames:
        a, b = got.step(c, v, k, s, lag), ref.step(c, v, k, s, lag)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        out.append(a)
    return out


@pytest.mark.parametrize("name", ["constant_velocity", "crossing",
                                  "occlusion", "expiry", "class_gating"])
def test_tracker_matches_the_reference_on_the_scripted_cases(name):
    ids = _both(_scripted(name), class_names=CLASSES)
    if name == "constant_velocity":
        assert len({int(i[0]) for i in ids}) == 1
    if name in ("occlusion", "expiry"):
        seen = [int(i[0]) for i in ids if len(i)]
        assert len(set(seen)) == (1 if name == "occlusion" else 2)


@pytest.mark.parametrize("gate", [None, 2.0, {"car": 1.0, "truck": 6.0}])
@pytest.mark.parametrize("max_age", [1, 3])
def test_tracker_and_sequences_match_the_reference(gate, max_age):
    rs = np.random.RandomState(7 + max_age)
    for _ in range(3):
        _, det = _scene(rs)
        ids = _both(det, match_dist=gate, max_age=max_age)
        seq = [{"centers": c, "velocities": v, "classes": k, "scores": s,
                "timestamp": 100.0 + 0.5 * t}
               for t, (c, v, k, s, _) in enumerate(det)]
        got = ttr.track_sequence(seq, DETECTION_CLASSES, gate, max_age)
        ref = jtr.track_sequence(seq, DETECTION_CLASSES, gate, max_age)
        for a, b, c in zip(got, ref, ids, strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert max(int(i.max()) for i in got if len(i)) < sum(
            len(i) for i in got)  # tracks persist


def _golden_cases():
    perfect = ([_frame([[float(t), 0.0]], [0], ids=[0]) for t in range(4)],
               [_frame([[float(t), 0.0]], [0], scores=[1.0], ids=[5])
                for t in range(4)])
    switch = ([_frame([[0.0, 0.0]], [0], ids=[0]) for _ in range(4)],
              [_frame([[0.0, 0.0]], [0], scores=[1.0],
                      ids=[10 if t < 2 else 11]) for t in range(4)])
    sweep = ([_frame([[0.0, 0.0]], [0], ids=[0])] * 2,
             [_frame([[0.0, 0.0]], [0], scores=[0.9], ids=[1]),
              _frame([[10.0, 10.0]], [0], scores=[0.8], ids=[2])])
    far = ([_frame([[100.0, 0.0]], [0], ids=[0])],
           [_frame([[100.0, 0.0]], [0], scores=[0.9], ids=[1])])
    near = ([{**far[0][0], "ego": np.array([99.0, 0.0])}],
            [{**far[1][0], "ego": np.array([99.0, 0.0])}])
    return {"perfect": perfect, "switch": switch, "sweep": sweep,
            "far": far, "near": near}


def test_evaluate_tracking_matches_the_reference_on_the_goldens():
    for name, (gt, dt) in _golden_cases().items():
        got = tte.evaluate_tracking([gt], [dt], class_names=CLASSES)
        ref = jte.evaluate_tracking([gt], [dt], class_names=CLASSES)
        assert got == ref, name
    assert tte.evaluate_tracking(*map(lambda x: [x], _golden_cases()[
        "sweep"]), class_names=CLASSES)["AMOTA"] == pytest.approx(18 / 40)
    no_ego_g = [[_frame([[1.0, 0.0]], [0], ids=[0], ego=False)]]
    no_ego_d = [[_frame([[1.0, 0.0]], [0], scores=[1.0], ids=[1],
                        ego=False)]]
    with pytest.raises(ValueError, match="ego"):
        tte.evaluate_tracking(no_ego_g, no_ego_d, class_names=CLASSES)
    assert tte.evaluate_tracking(no_ego_g, no_ego_d, class_names=CLASSES,
                                 class_range={}) == jte.evaluate_tracking(
        no_ego_g, no_ego_d, class_names=CLASSES, class_range={})
    with pytest.raises(ValueError, match="frames"):
        tte.evaluate_tracking([no_ego_g[0] * 2], no_ego_d,
                              class_names=CLASSES, class_range={})
    with pytest.raises(ValueError, match="scenes"):
        tte.evaluate_tracking(no_ego_g * 2, no_ego_d, class_names=CLASSES)


def test_evaluate_tracking_matches_the_reference_on_seeded_scenes():
    rs = np.random.RandomState(3)
    gt_scenes, dt_scenes = [], []
    for _ in range(3):
        gt, det = _scene(rs, n_frames=8)
        ids = ttr.track_sequence(
            [{"centers": c, "velocities": v, "classes": k, "scores": s,
              "timestamp": 0.5 * t}
             for t, (c, v, k, s, _) in enumerate(det)], DETECTION_CLASSES)
        ego = rs.uniform(-5, 5, 2)
        gt_scenes.append([{"centers": c, "ids": i, "classes": k, "ego": ego}
                          for c, k, i in gt])
        dt_scenes.append([{"centers": d[0], "ids": i, "classes": d[2],
                           "scores": d[3], "ego": ego}
                          for d, i in zip(det, ids)])
    got = tte.evaluate_tracking(gt_scenes, dt_scenes, DETECTION_CLASSES)
    ref = jte.evaluate_tracking(gt_scenes, dt_scenes, DETECTION_CLASSES)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k
    assert 0 < got["AMOTA"] < 1
    assert len([k for k in got if k.startswith("AMOTA_")]) >= 5


def test_tracking_scenes_score_the_ground_truth_perfectly(tiny):  # noqa: F811
    """The GT fed back as detections through the global frame, the
    tracker and the protocol: AMOTA 1, AMOTP 0, no switch."""
    ds = tev.nuscenes_dataset(tiny["records"])
    frames = []
    for i in range(len(ds)):
        ex = ds[i]
        gm = ex["gt_mask"]
        frames.append(({k: ex[k] for k in tev.NUSC_FRAME_KEYS},
                       {"boxes": ex["gt_boxes"][gm],
                        "scores": np.ones(int(gm.sum()), np.float32),
                        "labels": ex["gt_classes"][gm] - 1}))
    timings = {}
    gt_scenes, dt_scenes = tev.tracking_scenes(frames, timings)
    assert set(timings) == {"track"} and len(gt_scenes) == 2
    m = tte.evaluate_tracking(gt_scenes, dt_scenes, DETECTION_CLASSES)
    assert m["AMOTA"] == 1.0 and m["AMOTP"] == 0.0 and m["IDS"] == 0
    frames[0][0].pop("scene")
    with pytest.raises(ValueError, match="tracking metadata"):
        tev.tracking_scenes(frames)


def _captured(monkeypatch, module, name):
    seen = []
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append(args)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_nuscenes_tracking_evaluate_matches_the_reference(tiny,  # noqa: F811
                                                          monkeypatch):
    jm, variables = tiny["jax"]["single"]
    seen_t = _captured(monkeypatch, tev, "evaluate_tracking")
    seen_j = _captured(monkeypatch, jte, "evaluate_tracking")
    ref = jev.nuscenes_tracking_evaluate(jm, variables, tiny["pattern"])
    timings = {}
    with _one_torch_thread():
        got = tev.nuscenes_tracking_evaluate(tiny["port"]["single"],
                                             tiny["records"],
                                             timings=timings)
    assert set(timings) == {"load", "copy", "predict", "track", "evaluate"}
    (gt_t, dt_t, _), (gt_j, dt_j, _) = seen_t[0], seen_j[0]
    n = 0
    for gs_t, gs_j, ds_t, ds_j in zip(gt_t, gt_j, dt_t, dt_j, strict=True):
        for g, r in zip(gs_t, gs_j, strict=True):
            np.testing.assert_allclose(g["centers"], r["centers"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(g["ids"], r["ids"])
        for d, r in zip(ds_t, ds_j, strict=True):
            assert len(d["centers"]) == len(r["centers"])
            for c, i, s in zip(d["centers"], d["ids"], d["scores"]):
                j = int(np.argmin(np.abs(r["centers"] - c).max(1)))
                np.testing.assert_allclose(r["centers"][j], c, atol=1e-4)
                assert abs(r["scores"][j] - s) < 1e-5
                assert r["ids"][j] == i
                n += 1
    assert n > 100
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert 0 < got["AMOTA"] < 1


def test_nuscenes_tracking_evaluate_refined_matches_the_reference(
        tiny):  # noqa: F811
    """The CLI's ``--options tracking=true refined=true`` and
    ``--max-images``: the two-stage model's refined detections tracked over
    the first five keyframes, both sides' tables within 1e-6."""
    jm, variables = tiny["jax"]["two"]
    ref = jev.nuscenes_tracking_evaluate(jm, variables, tiny["pattern"],
                                         refined=True, max_frames=5)
    with _one_torch_thread():
        got = tev.nuscenes_tracking_evaluate(tiny["port"]["two"],
                                             tiny["records"], refined=True,
                                             max_frames=5)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6), k
