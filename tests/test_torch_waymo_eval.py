"""The port's Waymo evaluator and evaluation vs the JAX package's, on the
CPU.

- ``evaluate_waymo`` and its parts (``_heading_accuracy``,
  ``_match_frame``, ``_ap_from_matches``) on hand-built scenes: L1's ignored
  LEVEL_2 GT (by point count and by the labeller's difficulty), matches
  and misses at the classes' IoU thresholds, headings across +-pi and
  flipped by pi, score ties, classes as names and as ids (one out of
  range), frames without GT or detections, and the range breakdowns: every
  entry within 1e-12. The detections lie clear of the thresholds (IoU 1,
  0.8-0.96, or below 0.4), so the reference's XLA rotated IoU on the CPU,
  which clips in absolute coordinates, and the port's pair-relative clip
  make the same matches.
- ``waymo_evaluate`` end to end by the plain and refined routes on the JAX
  tests' tiny model (``tests/test_waymo_path.py``: one task of 3 classes,
  80 x 80 pillars of 1.92 m over +-76.8 m, max_voxels 1500; a two-stage
  one with 16 proposals and a refine width of 32), random weights carried
  across with ``centerpoint_from_flax`` and calibrated so that scores
  spread over (0, 1) and every stage-1 heading 0 (APH is linear in the
  headings, which the f32 networks give ~1e-5 rad apart), both sides'
  predict at 128 candidates: a frame from ``synthetic_waymo_records``
  (its cloud cut to 6,000-9,000 points, the predict batch of 2 padded with
  a copy) with GT made from the model's own detections; the same GT
  annos, the same
  detections (by box, 1e-4; scores 1e-5) and the same table (1e-6), with
  and without the range breakdowns.

The reference's ``rotated_iou_3d`` runs jitted on inputs padded to
IOU_PAD rows with zero boxes, its real rows sliced back (the pairs are
independent): eager, it compiles at every new shape, ~30 s for one table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_waymo_data import _one_torch_thread, small_records

from minddet_tpu.data import waymo_eval as jwe
from minddet_tpu.data.records import write_records
from minddet_tpu.models.detectors.centerpoint import CenterPoint as JCP
from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCP2)
from minddet_tpu.train import evaluate as jev
from minddet_tpu_torch.data import waymo_eval as twe
from minddet_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.train import evaluate as tev
from minddet_tpu_torch.utils.convert import centerpoint_from_flax

CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
IOU_PAD = 128  # rows of the reference's IoU inputs (every frame has fewer)
SIZES = {1: (1.9, 4.5, 1.7), 2: (0.85, 0.9, 1.75), 3: (0.8, 1.8, 1.75)}


@pytest.fixture(scope="module", autouse=True)
def _reference_iou_at_one_shape():
    iou = jax.jit(jwe.rotated_iou_3d)

    def padded(a, b):
        n, m = a.shape[0], b.shape[0]
        assert n <= IOU_PAD and m <= IOU_PAD
        pa = np.zeros((IOU_PAD, 7), np.float32)
        pb = np.zeros((IOU_PAD, 7), np.float32)
        pa[:n], pb[:m] = a, b
        return np.asarray(iou(pa, pb))[:n, :m]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwe, "rotated_iou_3d", padded)
        yield


# -- the evaluator on hand-built scenes ---------------------------------------

def _box(x, y, cls, yaw):
    w, l, h = SIZES[cls]
    return [x, y, 0.1, w, l, h, yaw]


def _along(box, d, dyaw=0.0):
    """``box`` moved by ``d`` metres along its length, turned by dyaw."""
    b = list(box)
    b[0] += d * -np.sin(b[6])  # the length runs along the yaw's normal
    b[1] += d * np.cos(b[6])
    b[6] += dyaw
    return b


def _scene(rs, n_frames=4):
    """Frames of GT and detections per class at ranges 5-70 m: per GT one
    of a copy (IoU 1), a match 0.1 m off (IoU 0.8-0.96), one too far off
    for its class's threshold (IoU < 0.4), a heading turned by 0.05 across
    +-pi or flipped by pi, or a miss; LEVEL_2 by point count (<= 5) or by
    difficulty 2 on some; false positives apart from every GT; score ties;
    and one frame with no GT and one with no detection."""
    gts, dts = [], []
    for f in range(n_frames):
        gb, gc, npts, diff, db, dc, ds = [], [], [], [], [], [], []
        for i in range(18):
            cls = 1 + i % 3
            kind = rs.randint(7)
            r, a = rs.uniform(5, 70), rs.uniform(-np.pi, np.pi)
            yaw = np.pi - 0.02 if kind == 3 else rs.uniform(-np.pi, np.pi)
            g = _box(r * np.cos(a), r * np.sin(a), cls, yaw)
            if any(np.hypot(g[0] - o[0], g[1] - o[1]) < 8 for o in gb):
                continue
            gb.append(g)
            gc.append(cls)
            npts.append(int(rs.randint(0, 6)) if rs.rand() < 0.2
                        else int(rs.randint(6, 500)))
            diff.append(2 if rs.rand() < 0.15 else 1)
            if kind == 0:
                d = list(g)
            elif kind in (1, 3):
                d = _along(g, 0.1 if cls == 1 else 0.05,
                           0.05 if kind == 3 else 0.0)
                if kind == 3:  # across +-pi: yaw pi - 0.02 -> -pi + 0.03
                    d[6] -= 2 * np.pi
            elif kind == 2:
                d = _along(g, 2.0 if cls == 1 else 0.5)
            elif kind == 4:
                d = _along(g, 0.0, np.pi)
            else:
                continue
            db.append(d)
            dc.append(cls)
            ds.append(round(rs.uniform(0.2, 1.0), 1))  # ties
        for _ in range(3):  # false positives far from every GT
            a = rs.uniform(-np.pi, np.pi)
            db.append(_box(90 * np.cos(a), 90 * np.sin(a), 1, a))
            dc.append(int(rs.randint(1, 4)))
            ds.append(round(rs.uniform(0.2, 1.0), 1))
        if f == 1:
            gb, gc, npts, diff = [], [], [], []
        if f == 2:
            db, dc, ds = [], [], []
        gts.append({"boxes": np.asarray(gb, np.float64).reshape(-1, 7),
                    "classes": np.asarray(gc, np.int32),
                    "num_points": np.asarray(npts, np.int32),
                    "difficulty": np.asarray(diff, np.int32)})
        dts.append({"boxes": np.asarray(db, np.float64).reshape(-1, 7),
                    "classes": np.asarray(dc, np.int64),
                    "scores": np.asarray(ds, np.float64)})
    return gts, dts


def _assert_tables(got, ref, atol):
    assert set(got) == set(ref)
    for cls in ref:
        assert set(got[cls]) == set(ref[cls])
        for k in ref[cls]:
            assert got[cls][k] == pytest.approx(ref[cls][k], abs=atol), (
                cls, k)


def test_parts_match_the_reference():
    rs = np.random.RandomState(0)
    for a, b in rs.uniform(-4 * np.pi, 4 * np.pi, (200, 2)):
        assert twe._heading_accuracy(a, b) == jwe._heading_accuracy(a, b)
    for n in (0, 1, 40):
        scores = np.round(rs.rand(n), 1)
        flags = rs.randint(-1, 2, n).astype(np.int32)
        hws = rs.rand(n)
        for n_gt in (0, 3, 30):
            for heading in (False, True):
                assert twe._ap_from_matches(scores, flags, hws, n_gt,
                                            heading) == \
                    jwe._ap_from_matches(scores, flags, hws, n_gt, heading)
    gts, dts = _scene(rs, 1)
    g, d = gts[0], dts[0]
    for thr in (0.5, 0.7):
        ignore = g["num_points"] <= twe.L2_MAX_POINTS
        got = twe._match_frame(g["boxes"], ignore, d["boxes"], d["scores"],
                               thr)
        ref = jwe._match_frame(g["boxes"], ignore, d["boxes"], d["scores"],
                               thr)
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)
        assert (got[1] == 1).sum() > 3 and (got[1] == -1).sum() > 0
    assert set(twe.IOU_THRESHOLDS.items()) == set(jwe.IOU_THRESHOLDS.items())
    assert (twe.N_RECALL_PTS, twe.L2_MAX_POINTS, twe.RANGE_BUCKETS) == (
        jwe.N_RECALL_PTS, jwe.L2_MAX_POINTS, jwe.RANGE_BUCKETS)


@pytest.mark.parametrize("breakdowns", [False, True])
def test_evaluator_matches_the_reference(breakdowns):
    gts, dts = _scene(np.random.RandomState(1))
    got = twe.evaluate_waymo(gts, dts, range_breakdowns=breakdowns)
    ref = jwe.evaluate_waymo(gts, dts, range_breakdowns=breakdowns)
    _assert_tables(got, ref, 1e-12)
    assert len(got["Vehicle"]) == (16 if breakdowns else 4)
    for cls in CLASSES:
        t = got[cls]
        assert 0 < t["APH_L1"] < t["AP_L1"] < 100
        assert t["AP_L2"] != t["AP_L1"]  # the LEVEL_2 GT count at L2
    if breakdowns:
        assert any(0 < v < 100 for k, v in got["Vehicle"].items()
                   if k.endswith("[50,inf)"))


def test_evaluator_names_ids_and_edge_cases_match_the_reference():
    gts, dts = _scene(np.random.RandomState(2), 3)
    names = np.array(CLASSES + ("Sign",))
    for g in gts:  # classes as names, and the GT's defaults
        g["classes"] = names[g["classes"] - 1]
        del g["difficulty"]
    del gts[0]["num_points"]
    dts[0]["classes"][-1] = 7  # an id out of range: no class
    for classes in (CLASSES, ("Vehicle", "Sign"), ("Cyclist",)):
        _assert_tables(twe.evaluate_waymo(gts, dts, classes),
                       jwe.evaluate_waymo(gts, dts, classes), 1e-12)
    flipped = [{"boxes": g["boxes"], "classes": g["classes"]} for g in gts]
    turned = [{"boxes": g["boxes"] + [0, 0, 0, 0, 0, 0, np.pi],
               "classes": g["classes"],
               "scores": np.ones(len(g["boxes"]))} for g in gts]
    got = twe.evaluate_waymo(flipped, turned)
    _assert_tables(got, jwe.evaluate_waymo(flipped, turned), 1e-12)
    assert got["Vehicle"]["AP_L1"] == pytest.approx(100.0)
    assert got["Vehicle"]["APH_L1"] < 1.0  # the same footprint, turned
    empty = [{"boxes": np.zeros((0, 7)), "classes": np.zeros(0, np.int32),
              "scores": np.zeros(0)}]
    _assert_tables(twe.evaluate_waymo(empty, empty, range_breakdowns=True),
                   jwe.evaluate_waymo(empty, empty, range_breakdowns=True),
                   0)


# -- waymo_evaluate end to end -------------------------------------------------

TINY_WAYMO = dict(task_num_classes=(3,), grid_ny=80, grid_nx=80,
                  voxel_size=(1.92, 1.92, 6.0),
                  pc_range=(-76.8, -76.8, -2.0, 76.8, 76.8, 4.0),
                  max_voxels=1500)
TWO_STAGE = dict(refine_hidden=32)
PREDICT = dict(nms_pre=128)  # the candidates of both sides' predict
POINTS = (6000, 9000)
FRAMES = 1  # one predict batch, its tail padded
HM_SPREAD, HM_CENTRE = 2.0, -2.0
GT_FROM_DETECTIONS = 12
METHODS = ("predict_from_points", "predict_refined")


def _jax_at(cls):
    """A subclass of the reference's model whose predict methods take
    PREDICT's candidates."""

    class Small(cls):
        def predict_from_points(self, points, mask):
            return cls.predict_from_points(self, points, mask, **PREDICT)

        if cls is JCP2:
            def predict_refined(self, points, mask):
                return cls.predict_refined(self, points, mask, **PREDICT)

    return Small


def _port_at(model):
    for name in METHODS:
        if hasattr(model, name):
            setattr(model, name, functools.partial(getattr(model, name),
                                                   **PREDICT))
    return model


def _calibrated(variables, pts, mask):
    """The heatmap logits at std HM_SPREAD about HM_CENTRE on the clouds,
    sizes ~2.5 m, headings 0, the refine head's box deltas small."""
    port = centerpoint_from_flax(CenterPointTwoStage(**TINY_WAYMO,
                                                     **TWO_STAGE).eval(),
                                 variables)
    with torch.no_grad():
        hm = port(torch.from_numpy(pts), torch.from_numpy(mask))[0][
            "hm"].numpy()
    out = variables["params"]["head"]["task0"]["hm_out"]
    gain = HM_SPREAD / hm.std((0, 1, 2))
    out["bias"] = ((out["bias"] - hm.mean((0, 1, 2))) * gain
                   + HM_CENTRE).astype(np.float32)
    out["kernel"] = (out["kernel"] * gain).astype(np.float32)
    dim = variables["params"]["head"]["task0"]["dim_out"]
    dim["kernel"] = dim["kernel"] * np.float32(0.3)
    dim["bias"] = dim["bias"] + np.float32(0.9)
    # every heading (sin, cos) = (0, 1): yaw 0 on both sides exactly. APH is
    # linear in the headings, and the f32 network's yaws differ by ~1e-5
    # rad between the packages, which would move it by ~2e-5 (percent)
    rot = variables["params"]["head"]["task0"]["rot_out"]
    rot["kernel"] = np.zeros_like(rot["kernel"])
    rot["bias"] = np.array([0.0, 1.0], np.float32)
    box = variables["params"]["refine"]["box"]
    box["kernel"] = box["kernel"] * np.float32(0.01)
    box["bias"] = box["bias"] * np.float32(0.01)
    return variables


def _with_detected_gt(records, det, rs):
    """Per frame, the GT replaced by the model's top GT_FROM_DETECTIONS
    detections above 0.3 (7-wide z-bottom): a third in place, a third 0.1
    m off (IoU ~0.9 at ~2.5 m sizes), a third 1.5 m off (IoU < 0.3), each
    turned by 0.02-0.08 rad, a third of them at 0-5 lidar points (LEVEL_2).
    The NMS left no two detections at a BEV IoU over 0.2, so every IoU
    between a detection and a GT lies clear of the protocol's thresholds.
    The turn keeps each heading weight clear of 1: at weights of exactly 1
    the weighted recall of a fully detected class lands on a grid point of
    the interpolation, which the reference's detections, ~1e-7 rad off the
    port's, miss by 1e-7 (its APH then loses that point, ~1 % of the
    class's)."""
    for i, r in enumerate(records):
        keep = np.nonzero(det["scores"][i] > 0.3)[0][:GT_FROM_DETECTIONS]
        b9 = det["boxes"][i][keep].astype(np.float64)
        off = rs.choice([0.0, 0.1, 1.5], len(keep))
        ang = rs.uniform(-np.pi, np.pi, len(keep))
        b9[:, 0] += off * np.cos(ang)
        b9[:, 1] += off * np.sin(ang)
        b9[:, 8] += rs.choice([-1.0, 1.0], len(keep)) * rs.uniform(
            0.02, 0.08, len(keep))
        b7 = np.concatenate([b9[:, :2], b9[:, 2:3] - b9[:, 5:6] / 2,
                             b9[:, 3:6], b9[:, 8:9]], 1).astype(np.float32)
        r.update(gt_boxes=b7,
                 gt_classes=(det["labels"][i][keep] + 1).astype(np.int32),
                 num_points_in_gt=np.where(
                     rs.rand(len(keep)) < 1 / 3, rs.randint(0, 6, len(keep)),
                     rs.randint(6, 300, len(keep))).astype(np.int32))
    return records


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny models on both sides (the single-stage one from the
    two-stage one's variables without the refine head), the frames in
    memory and as records."""
    records = small_records(FRAMES, seed=3, points=POINTS)
    ds = tev.waymo_dataset(records)
    exs = [ds[i] for i in range(FRAMES)]
    pts = np.stack([e["points"] for e in exs])
    mask = np.stack([e["points_mask"] for e in exs])
    j2 = _jax_at(JCP2)(**TINY_WAYMO, **TWO_STAGE, num_proposals=16)
    shapes = jax.eval_shape(lambda: j2.init(
        jax.random.PRNGKey(0), jnp.asarray(pts[:1, :512]),
        jnp.asarray(mask[:1, :512]), method=j2.predict_refined))
    with _one_torch_thread():
        v2 = _calibrated(jax.tree_util.tree_map(np.array, random_variables(
            {"params": dict(shapes["params"]),
             "batch_stats": dict(shapes["batch_stats"])}, seed=5)), pts,
            mask)
        v1 = {k: {n: v for n, v in v2[k].items() if n != "refine"}
              for k in ("params", "batch_stats")}
        port1 = _port_at(centerpoint_from_flax(
            CenterPoint(**TINY_WAYMO).eval(), v1))
        port2 = _port_at(centerpoint_from_flax(CenterPointTwoStage(
            **TINY_WAYMO, **TWO_STAGE).eval(), v2))
        with torch.no_grad():
            det = port1.predict_from_points(torch.from_numpy(pts),
                                            torch.from_numpy(mask))
    det = {k: det[k].numpy() for k in ("boxes", "scores", "labels")}
    records = _with_detected_gt(records, det, np.random.RandomState(4))
    root = tmp_path_factory.mktemp("waymo")
    write_records(str(root / "val"), records)
    return dict(records=records, pattern=str(root / "val-*.arrayrecord"),
                jax={"plain": (_jax_at(JCP)(**TINY_WAYMO), v1),
                     "refined": (j2, v2)},
                port={"plain": port1, "refined": port2})


def _captured(monkeypatch, module, name):
    seen = []
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def _assert_same_detections(got, ref):
    """Per frame, the port's detections are the reference's as sets: each
    matched one to one by class, box (1e-4) and score (1e-5)."""
    n = 0
    for g, r in zip(got, ref, strict=True):
        assert len(g["boxes"]) == len(r["boxes"])
        used = np.zeros(len(r["boxes"]), bool)
        for b, c, s in zip(g["boxes"], g["classes"], g["scores"]):
            ok = (~used & (r["classes"] == c)
                  & (np.abs(r["boxes"] - b).max(1) < 1e-4)
                  & (np.abs(r["scores"] - s) < 1e-5))
            assert ok.any(), (b, c, s)
            used[int(np.argmax(ok))] = True
            n += 1
    return n


@pytest.mark.parametrize("route", ["plain", "refined"])
def test_waymo_evaluate_matches_the_reference(tiny, route, monkeypatch):
    refined = route == "refined"
    jm, variables = tiny["jax"][route]
    seen_t = _captured(monkeypatch, tev, "evaluate_waymo")
    seen_j = _captured(monkeypatch, jwe, "evaluate_waymo")
    ref = jev.waymo_evaluate(jm, variables, tiny["pattern"], batch_size=2,
                             refined=refined)
    timings = {}
    with _one_torch_thread():
        got = tev.waymo_evaluate(tiny["port"][route], tiny["records"],
                                 refined=refined, timings=timings)
    assert set(timings) == {"load", "copy", "predict", "evaluate"}
    ((gt_t, dt_t), kw_t), ((gt_j, dt_j), kw_j) = seen_t[0], seen_j[0]
    assert kw_t["classes"] == kw_j["classes"] == tev.WAYMO_EVAL_NAMES
    for g, r in zip(gt_t, gt_j, strict=True):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert _assert_same_detections(dt_t, dt_j) > 20
    _assert_tables(got, ref, 1e-6)
    assert any(0 < v < 100 for t in got.values() for v in t.values())
    # the range breakdowns on the same annos
    _assert_tables(twe.evaluate_waymo(gt_t, dt_t, tev.WAYMO_EVAL_NAMES, True),
                   jwe.evaluate_waymo(gt_j, dt_j, tev.WAYMO_EVAL_NAMES, True),
                   1e-6)


def test_waymo_evaluate_needs_a_two_stage_model_to_refine(tiny):
    with pytest.raises(ValueError, match="two-stage"):
        tev.waymo_evaluate(tiny["port"]["plain"], tiny["records"],
                           refined=True)
    with pytest.raises(ValueError, match="at least one frame"):
        tev.waymo_evaluate(tiny["port"]["plain"], [])
