"""The port's nuScenes evaluator, its evaluations and the config's optimizer
vs the JAX package's, on the CPU.

- ``evaluate_nuscenes`` and its parts (``filter_eval_boxes``,
  ``accumulate_class``, ``metric_data``, ``calc_ap``, ``calc_tp``) on the
  oracle fixtures of ``tests/test_nuscenes_eval_oracle.py`` (threshold
  distances, the class range, score ties, greedy steals, points-free GT,
  void attributes, empty samples, barrier's pi period) and on several
  classes at once: every entry within 1e-12.
- ``nuscenes_evaluate`` end to end by the plain, TTA and refined routes on
  a tiny CenterPoint (grid 128 x 128 of 0.8 m cells over nuScenes' range,
  six tasks over the ten classes, RPN (1, 1, 1), a two-layer PFN, heads
  calibrated so that scores spread over (0, 1)), weights carried across
  with ``centerpoint_from_flax``, both sides' predict at 128 candidates
  a task, every NMS survivor kept (the plain K4 at the protocol's 1000
  costs ~11 s a batch on the CPU); keyframes from
  ``synthetic_nuscenes_records`` (their clouds cut to 6,000-9,000 points)
  with GT made from the model's own car detections, so that the table is
  not all zeros: the same detections (by box, 1e-4; scores 1e-5) and the
  same metrics (1e-6).
- One step of ``entry.nuscenes_optimizer`` (the config's AdamW with decay
  0.01 and clip 35 under ``one_cycle(2e-3, 140000)``, the NaN guard) on
  the tiny single-stage model fed one ``nuscenes_batches`` batch, f64
  parameters and compute on both sides, against the reference's
  ``build_optimizer`` + ``build_schedule``: the loss parts and grad_norm
  1e-6, each Adam moment within 1e-5 of its largest, the parameters within
  1e-6 where the moment resolves the element and within 1e-10 where the
  gradient is above 1e4 times Adam's eps (so that the decoupled decay,
  2e-6 p, shows), the BN statistics 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_nuscenes_eval_oracle import _bx, _fixture_pack, _sample
from test_torch_centerpoint_train import _noise_only, _one_torch_thread
from test_torch_nuscenes_data import small_records
from test_torch_pointpillars import random_variables

from minddet_tpu.core.lr_schedules import build_schedule
from minddet_tpu.core.optim import build_optimizer
from minddet_tpu.data import nuscenes_eval as jne
from minddet_tpu.data.records import write_records
from minddet_tpu.models.detectors.centerpoint import CenterPoint as JCP
from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCP2)
from minddet_tpu.train import evaluate as jev
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch import entry
from minddet_tpu_torch.core.lr_schedules import one_cycle
from minddet_tpu_torch.data import nuscenes_eval as tne
from minddet_tpu_torch.data.nuscenes import (DETECTION_CLASSES,
                                             infer_attributes)
from minddet_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.train import evaluate as tev
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import nuscenes_batches
from minddet_tpu_torch.utils.convert import (adamw_state_from_optax,
                                             centerpoint_from_flax)

TINY_NUSC = dict(task_num_classes=(1, 2, 2, 1, 2, 2), grid_ny=128,
                 grid_nx=128, voxel_size=(0.8, 0.8, 8.0),
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 pfn_filters=(16, 16), rpn_layer_nums=(1, 1, 1),
                 rpn_filters=(16, 32, 64), rpn_up_filters=(16, 16, 16),
                 max_voxels=4096, max_points_per_voxel=8, out_size_factor=4)
TWO_STAGE = dict(refine_hidden=32)
PREDICT = dict(nms_pre=128, nms_post=128)  # every NMS survivor kept
POINTS = (6000, 9000)  # the tests' clouds (``small_records``)
MAX_POINTS = 6000
HM_SPREAD, HM_CENTRE = 2.0, -2.0
GT_FROM_DETECTIONS = 8
FRAMES, SCENES = 6, 2
METHODS = ("predict_from_points", "predict_tta_double_flip",
           "predict_refined")


# -- the evaluator on the oracle fixtures ------------------------------------

def _assert_tables(got, ref, atol):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=atol), k


@pytest.mark.parametrize("cls", ["car", "pedestrian", "barrier",
                                 "traffic_cone"])
def test_evaluator_matches_the_reference_on_the_oracle_fixtures(cls):
    for seed in (0, 3):
        gts, dts = _fixture_pack(cls, seed=seed)
        fg, fd = tne.filter_eval_boxes(gts, dts, cls)
        jfg, jfd = jne.filter_eval_boxes(gts, dts, cls)
        for th in tne.DIST_THRESHOLDS:
            acc = tne.accumulate_class(fg, fd, th, cls)
            jacc = jne.accumulate_class(jfg, jfd, th, cls)
            for k in ("scores", "tp", "gidx", "tp_conf", "tp_gidx"):
                np.testing.assert_array_equal(acc[k], jacc[k], err_msg=k)
            md, jmd = tne.metric_data(acc), jne.metric_data(jacc)
            for k in jmd:
                np.testing.assert_allclose(md[k], jmd[k], rtol=0,
                                           atol=1e-12, err_msg=k)
            assert tne.calc_ap(md) == pytest.approx(jne.calc_ap(jmd),
                                                    abs=1e-12)
            for m in tne.TP_METRICS:
                assert tne.calc_tp(md, m) == pytest.approx(
                    jne.calc_tp(jmd, m), abs=1e-12)
        _assert_tables(tne.evaluate_nuscenes({cls: gts}, {cls: dts}, [cls]),
                       jne.evaluate_nuscenes({cls: gts}, {cls: dts}, [cls]),
                       1e-12)


def test_evaluator_matches_the_reference_over_classes():
    classes = list(DETECTION_CLASSES)
    gt_by, dt_by = {}, {}
    for i, c in enumerate(classes[:-2]):
        gt_by[c], dt_by[c] = _fixture_pack(c, seed=10 + i, n_samples=8)
    # a class with GT and no detections, and a perfect one with an ego
    # offset (boxes in a global frame)
    gt_by["pedestrian"] = [_sample([_bx(1, 1)]), _sample([_bx(2, 2)])]
    dt_by["pedestrian"] = [_sample(np.zeros((0, 9)), scores=[])] * 2
    gt_by["traffic_cone"] = [_sample([_bx(301, 2)], ego=(300, 0))]
    dt_by["traffic_cone"] = [_sample([_bx(301, 2)], scores=[0.5],
                                     ego=(300, 0))]
    got = tne.evaluate_nuscenes(gt_by, dt_by, classes)
    ref = jne.evaluate_nuscenes(gt_by, dt_by, classes)
    _assert_tables(got, ref, 1e-12)
    assert 0 < got["mAP"] < 1 and 0 < got["NDS"] < 1
    assert got["AP_pedestrian"] == 0
    assert got["AP_traffic_cone"] == pytest.approx(1.0, abs=1e-12)
    custom = {"car": 20.0}
    _assert_tables(tne.evaluate_nuscenes(gt_by, dt_by, ["car"], custom),
                   jne.evaluate_nuscenes(gt_by, dt_by, ["car"], custom),
                   1e-12)


# -- the evaluations end to end ----------------------------------------------

def _jax_at(cls):
    """A subclass of the reference's model whose predict methods take
    PREDICT's candidates and kept detections."""

    class Small(cls):
        def predict_from_points(self, points, mask):
            return cls.predict_from_points(self, points, mask, **PREDICT)

        def predict_tta_double_flip(self, points, mask):
            return cls.predict_tta_double_flip(self, points, mask, **PREDICT)

        if cls is JCP2:
            def predict_refined(self, points, mask):
                return cls.predict_refined(self, points, mask, **PREDICT)

    return Small


def _port_at(model):
    """The port's model with PREDICT's candidates and kept detections."""
    for name in METHODS:
        if hasattr(model, name):
            setattr(model, name, functools.partial(getattr(model, name),
                                                   **PREDICT))
    return model


def _calibrated(variables, pts, mask):
    """Every task's heatmap logits at std HM_SPREAD about HM_CENTRE on the
    clouds, sizes ~2.5 m, the refine head's box deltas small."""
    port = centerpoint_from_flax(CenterPointTwoStage(**TINY_NUSC,
                                                     **TWO_STAGE).eval(),
                                 variables)
    with torch.no_grad():
        preds = port(torch.from_numpy(pts), torch.from_numpy(mask))
    for t, pred in enumerate(preds):
        task = variables["params"]["head"][f"task{t}"]
        hm = pred["hm"].numpy()
        gain = HM_SPREAD / hm.std((0, 1, 2))
        out = task["hm_out"]
        out["bias"] = ((out["bias"] - hm.mean((0, 1, 2))) * gain
                       + HM_CENTRE).astype(np.float32)
        out["kernel"] = (out["kernel"] * gain).astype(np.float32)
        task["dim_out"]["kernel"] = task["dim_out"]["kernel"] * np.float32(0.3)
        task["dim_out"]["bias"] = task["dim_out"]["bias"] + np.float32(0.9)
    # the second stage refines a box by a few centimetres, not metres
    box = variables["params"]["refine"]["box"]
    box["kernel"] = box["kernel"] * np.float32(0.01)
    box["bias"] = box["bias"] * np.float32(0.01)
    return variables


def _stack(records):
    pts = np.zeros((len(records), MAX_POINTS, 5), np.float32)
    for i, r in enumerate(records):
        pts[i] = r["points"][:MAX_POINTS]
    return pts, np.ones((len(records), MAX_POINTS), bool)


def _with_detected_gt(records, det, rs):
    """Per keyframe, the GT replaced by the model's first task's (car's)
    top GT_FROM_DETECTIONS detections above 0.3, jittered, each with a
    track id of its own, so that every metric has entries (the model
    detects none of the keyframe's own objects)."""
    next_id = 0
    for i, r in enumerate(records):
        keep = np.nonzero((det["scores"][i] > 0.3)
                          & (det["labels"][i] == 0))[0][:GT_FROM_DETECTIONS]
        boxes = det["boxes"][i][keep].astype(np.float32)
        boxes[:, :2] += rs.uniform(-0.3, 0.3, (len(keep), 2))
        classes = (det["labels"][i][keep] + 1).astype(np.int32)
        r.update(gt_boxes=boxes, gt_classes=classes,
                 gt_attrs=infer_attributes(boxes, classes),
                 gt_track_ids=next_id + np.arange(len(keep), dtype=np.int32))
        next_id += len(keep)
    return records


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny models on both sides (the single-stage one from the
    two-stage one's variables without the refine head), the keyframes in
    memory and as records."""
    records = small_records(FRAMES, seed=3, scenes=SCENES, points=POINTS)
    pts, mask = _stack(records)
    j2 = _jax_at(JCP2)(**TINY_NUSC, **TWO_STAGE, num_proposals=16)
    shapes = jax.eval_shape(lambda: j2.init(
        jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]),
        method=j2.predict_refined))
    v2 = _calibrated(jax.tree_util.tree_map(np.array, random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, seed=5)), pts, mask)
    v1 = {k: {n: v for n, v in v2[k].items() if n != "refine"}
          for k in ("params", "batch_stats")}
    port1 = _port_at(centerpoint_from_flax(CenterPoint(**TINY_NUSC).eval(),
                                           v1))
    port2 = _port_at(centerpoint_from_flax(CenterPointTwoStage(
        **TINY_NUSC, **TWO_STAGE).eval(), v2))
    # the detections on what the evaluations feed the model: each cloud
    # padded to the dataset's 120,000 points
    ds = tev.nuscenes_dataset(records)
    exs = [ds[i] for i in range(len(ds))]
    with torch.no_grad(), _one_torch_thread():
        det = port1.predict_from_points(
            torch.from_numpy(np.stack([e["points"] for e in exs])),
            torch.from_numpy(np.stack([e["points_mask"] for e in exs])))
    det = {k: det[k].numpy() for k in ("boxes", "scores", "labels")}
    records = _with_detected_gt(records, det, np.random.RandomState(4))
    root = tmp_path_factory.mktemp("nusc")
    write_records(str(root / "val"), records)
    return dict(records=records, pattern=str(root / "val-*.arrayrecord"),
                jax={"single": (_jax_at(JCP)(**TINY_NUSC), v1),
                     "two": (j2, v2)},
                port={"single": port1, "two": port2})


def _captured(monkeypatch, module, name):
    seen = []
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append(args)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def _assert_same_detections(got_by, ref_by):
    """Per class and frame, the port's detections are the reference's as
    sets: each matched one to one by box (1e-4) and score (1e-5)."""
    n = 0
    for cls in DETECTION_CLASSES:
        for g, r in zip(got_by[cls], ref_by[cls], strict=True):
            assert len(g["boxes"]) == len(r["boxes"]), cls
            used = np.zeros(len(r["boxes"]), bool)
            for b, s, a in zip(g["boxes"], g["scores"], g["attrs"]):
                d = np.abs(r["boxes"] - b).max(1) if len(used) else []
                ok = ~used & (d < 1e-4) & (np.abs(r["scores"] - s) < 1e-5)
                assert ok.any(), (cls, b)
                j = int(np.argmax(ok))
                used[j] = True
                assert r["attrs"][j] == a
                n += 1
    return n


@pytest.mark.parametrize("route", ["plain", "tta", "refined"])
def test_nuscenes_evaluate_matches_the_reference(tiny, route, monkeypatch):
    kind = "two" if route == "refined" else "single"
    jm, variables = tiny["jax"][kind]
    flags = entry.NUSC_ROUTES[route]
    seen_t = _captured(monkeypatch, tev, "evaluate_nuscenes")
    seen_j = _captured(monkeypatch, jne, "evaluate_nuscenes")
    ref = jev.nuscenes_evaluate(jm, variables, tiny["pattern"], **flags)
    timings = {}
    with _one_torch_thread():
        got = tev.nuscenes_evaluate(tiny["port"][kind], tiny["records"],
                                    timings=timings, **flags)
    assert set(timings) == {"load", "copy", "predict", "evaluate"}
    (gt_t, dt_t, _), (gt_j, dt_j, _) = seen_t[0], seen_j[0]
    for cls in DETECTION_CLASSES:
        for g, r in zip(gt_t[cls], gt_j[cls], strict=True):
            np.testing.assert_array_equal(g["boxes"], r["boxes"])
            np.testing.assert_array_equal(g["attrs"], r["attrs"])
    assert _assert_same_detections(dt_t, dt_j) > 50
    _assert_tables(got, ref, 1e-6)
    assert 0 < got["mAP"] < 1 and 0 < got["NDS"] < 1


def test_nuscenes_evaluate_needs_a_two_stage_model_to_refine(tiny):
    with pytest.raises(ValueError, match="two-stage"):
        tev.nuscenes_evaluate(tiny["port"]["single"], tiny["records"],
                              refined=True)
    with pytest.raises(ValueError, match="at least one frame"):
        tev.nuscenes_evaluate(tiny["port"]["single"], [])


# -- the config's optimizer on a fed batch ------------------------------------

PARTS = tuple(f"task{t}_{k}" for t in range(6) for k in ("hm", "loc"))
# the step's model: the tiny one on a coarser grid (1.6 m cells), which
# halves the reference's f64 step on the CPU
TINY_STEP = dict(TINY_NUSC, grid_ny=64, grid_nx=64, voxel_size=(1.6, 1.6, 8.0),
                 max_voxels=2048)


def test_nuscenes_optimizer_step_matches_the_reference():
    cfg = entry.read_config(entry.CP_CONFIG)
    tcfg = cfg["train"]
    data = dict(cfg["data"], records=small_records(
        4, seed=6, scenes=1, points=POINTS), max_points=MAX_POINTS,
                max_gt=96, workers=1)
    raw = next(nuscenes_batches({"data": data}, 2, seed=0))
    assert raw["gt_mask"].sum() > 30
    batch = {k: raw[k] for k in entry.KITTI_BATCH_KEYS}
    batch["gt_boxes"] = batch["gt_boxes"].astype(np.float64)
    jm = JCP(**TINY_STEP, dtype=jnp.float64)

    def loss_apply(v, b, train=True):
        return jm.apply(v, b, train=train, method=jm.loss_from_gt,
                        mutable=["batch_stats"])

    with _one_torch_thread(), jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["points"][:1]),
            jnp.asarray(batch["points_mask"][:1]),
            method=jm.predict_from_points))
        variables = jax.tree_util.tree_map(
            lambda a: np.array(a, np.float64), random_variables(
                {"params": dict(shapes["params"]),
                 "batch_stats": dict(shapes["batch_stats"])}, seed=7))
        tx = build_optimizer(dict(tcfg["optimizer"]),
                             build_schedule(dict(tcfg["lr_schedule"])))
        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(jstate, {k: jnp.asarray(v)
                                               for k, v in batch.items()}))
    model = centerpoint_from_flax(CenterPoint(
        **TINY_STEP, dtype=torch.float64).double(), variables)
    model = model.to(memory_format=torch.channels_last).train()
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    recipe = entry.nuscenes_optimizer(cfg)
    state = TrainState.create(model, recipe)
    with _one_torch_thread():
        state, metrics = make_train_step(entry.model_gt_loss)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == {"loss", "grad_norm", *PARTS}
    for name in jmetrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)
    assert sum(float(jmetrics[k]) > 1e-3 for k in PARTS) >= 8
    ref = centerpoint_from_flax(CenterPoint(
        **TINY_STEP, dtype=torch.float64).double(),
                                {"params": new_jstate.params,
                                 "batch_stats": new_jstate.batch_stats})
    ref_opt = recipe.init(ref)
    adamw_state_from_optax(ref, ref_opt, new_jstate.opt_state)
    got = dict(model.named_parameters())
    # the decoupled decay moves a parameter by lr * wd * p (2e-6 * p at
    # count 0, one_cycle's lr_max / 10): the f64 comparison at 1e-10 sees
    # it where |p| > 5e-5. Adam's first step, lr * g / (|g| + eps), moves
    # by lr * eps * dg / g**2 when the gradient moves by dg: where |g| >
    # 1e4 eps that is below lr * 1e-4 * dg / g, under 1e-10 for the
    # gradients' agreement here (a few 1e-5 relative where the BN'd
    # layers' terms cancel), so the check is made there
    sched = {k: v for k, v in tcfg["lr_schedule"].items() if k != "type"}
    decay = (float(one_cycle(**sched)(0))
             * float(tcfg["optimizer"]["weight_decay"]))
    eps = state.optimizer.param_groups[0]["eps"]
    atol = 1e-10
    unresolved = seen = tight_total = 0
    for name, r in ref.named_parameters():
        if _noise_only(name):
            continue
        assert r.dtype == got[name].dtype == torch.float64, name
        m_ref = ref_opt.state[r]["exp_avg"]
        m_got = state.optimizer.state[got[name]]["exp_avg"]
        scale = float(m_ref.abs().max())
        assert float((m_got - m_ref).abs().max()) <= 1e-5 * scale, name
        clear = (m_ref.abs() > 1e-5 * scale) & (m_ref.abs() > 0.1 * 1e-6)
        unresolved += int((~clear).sum())
        np.testing.assert_allclose(got[name].detach()[clear].numpy(),
                                   r.detach()[clear].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        tight = m_ref.abs() / (1 - 0.9) > 1e4 * eps
        np.testing.assert_allclose(got[name].detach()[tight].numpy(),
                                   r.detach()[tight].numpy(), rtol=0,
                                   atol=atol, err_msg=name)
        seen += int((decay * old[name][tight].abs() > 10 * atol).sum())
        tight_total += int(tight.sum())
    n_params = sum(p.numel() for p in got.values())
    assert unresolved < 2e-2 * n_params
    assert tight_total > 0.4 * n_params
    assert seen > 0.5 * tight_total
    bufs = dict(model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert int(state.optimizer.param_groups[0]["count"]) == 1
