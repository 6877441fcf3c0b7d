"""The port's YOLOX train path vs the JAX package's, on the CPU.

- ``simota_assign`` (the reference's one-image function under ``vmap``):
  exactly in f64 on boxes of dyadic coordinates over two levels (strides
  8 and 16 on 64 x 64, 80 anchor points). Image 0: a GT whose top-10
  candidate IoUs sum to 3 - 1/256 (dynamic k 2) where two anchors predict
  the GT itself with the same logits (their costs tie exactly at the
  cut: the lower anchor wins) and a third is cheaper; the same GT in a
  second slot (its costs tie the first's at every anchor: the first GT
  keeps every anchor); a GT between the anchor points, whose candidates
  are all non-strong (cost 1e4 up), two of them tied at its cut of 1; a
  padded slot holding a real box. Image 1: an anchor taken by two GTs
  (the cheaper keeps it), a GT whose IoUs sum to 2 + 1/576 (dynamic k 2),
  padded slots. In f32 on random boxes at the tiny model's 84 anchors: the
  discrete outputs equal, the matched IoUs 1e-6.
- ``YOLOX.loss`` and one train step of the tiny model of
  ``test_torch_yolox.py`` (width 0.125, depth 0.33, 4 classes, 64x64),
  weights through ``yolox_from_flax``, with the config's SGD (momentum
  0.9, Nesterov, decay 5e-4 on ndim > 1, inside the NaN guard) at a
  constant lr 0.01 (the warm-up's first step has lr 0): with f64 compute
  over f32 parameters (the head's outputs, the assignment and the losses
  in f32 on both sides, as the reference computes them) the three loss
  parts 1e-6, every gradient 1e-5 of its largest element, the parameters
  after the step 1e-6 plus the step's share of that gradient tolerance,
  the BN statistics 1e-6.
- The optimizer against optax: Nesterov SGD at momentum 0.9 and 0.937
  over three steps; both configs' ``warmup_cosine`` against the
  reference's (``optax.warmup_cosine_decay_schedule``) at the counts that
  matter.
- The train entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8_train import _params_and_grads, _run_both
from test_torch_yolox import TINY, _tiny_shapes

from minddet_tpu.core.lr_schedules import warmup_cosine as j_warmup_cosine
from minddet_tpu.core.optim import build_optimizer
from minddet_tpu.models.detectors import yolox as jyolox
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch.core.lr_schedules import warmup_cosine
from minddet_tpu_torch.core.optim import sgd, skip_nonfinite_updates
from minddet_tpu_torch.entry import (YOLO_COSINE_TOTAL_STEPS, YOLO_LR,
                                     YOLO_WEIGHT_DECAY, YOLOV5_MOMENTUM,
                                     YOLOV5_WARMUP, YOLOX_MOMENTUM,
                                     YOLOX_WARMUP, model_loss,
                                     yolox_train_entry)
from minddet_tpu_torch.models.detectors import yolox as tyolox
from minddet_tpu_torch.ops.box import pairwise_iou
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import (sgd_state_from_optax,
                                             yolox_from_flax)

PARTS = ("iou_loss", "obj_loss", "cls_loss")
STEP_LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_simota(boxes, obj, cls, points, strides, gt, classes, mask):
    fn = jax.vmap(lambda bx, ob, cl, gb, gc, gm: jyolox.simota_assign(
        bx, ob, cl, points, strides, gb, gc, gm))
    return jax.device_get(jax.jit(fn)(boxes, obj, cls, gt, classes, mask))


def _grid():
    pts, sts = jyolox.yolo_grid((64, 64), (8, 16))
    return pts.astype(np.float64), sts.astype(np.float64)


def _dyadic_case():
    """Two images over the anchor points of strides 8 (8 x 8, anchors 0-63,
    index row * 8 + column) and 16 (4 x 4, anchors 64-79) on 64 x 64; every
    anchor predicts a box far off the image unless set here, and the
    logits are random but where set."""
    rs = np.random.RandomState(21)
    points, strides = _grid()
    boxes = np.concatenate([points + 200, points + 204], -1)
    boxes = np.broadcast_to(boxes, (2, 80, 4)).copy()
    obj = rs.randn(2, 80)
    cls = rs.randn(2, 80, 4)
    gt = np.array([[[16, 16, 32, 32], [16, 16, 32, 32], [33, 33, 35, 35],
                    [0, 0, 64, 64]],
                   [[0, 0, 16, 16], [8, 8, 32, 32], [8, 8, 24, 24],
                    [40, 40, 48, 48]]], np.float64)
    classes = np.array([[1, 1, 2, 3], [0, 3, 2, 1]], np.int32)
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    # image 0, GT 0: anchors 18 and 19 predict it (IoU 1) with the same
    # logits, anchor 26 at IoU 255/256 is cheaper than both
    boxes[0, 18] = boxes[0, 19] = gt[0, 0]
    boxes[0, 26] = [16, 16, 32, 31.9375]
    obj[0, 18] = obj[0, 19] = 0.0
    cls[0, 18] = cls[0, 19] = 0.0
    obj[0, 26], cls[0, 26, 1] = 3.0, 3.0
    # GT 2 (no anchor point inside): anchors 36 and 37 predict half of it
    # with the same logits, the most confident of its candidates
    boxes[0, 36] = boxes[0, 37] = [33, 33, 35, 34]
    obj[0, 36] = obj[0, 37] = 4.0
    cls[0, 36] = cls[0, 37] = [0.0, 0.0, 4.0, 0.0]
    # image 1: anchor 9 (point (12, 12)) lies in GTs 0 and 1 and is far
    # cheaper for GT 1; anchor 27 predicts GT 1 itself, anchor 28 a box at
    # IoU 1/576 of it
    boxes[1, 9] = [8, 8, 32, 32]
    obj[1, 9], cls[1, 9] = 4.0, [-3.0, 0.0, 0.0, 4.0]
    boxes[1, 27] = gt[1, 1]
    obj[1, 27], cls[1, 27, 3] = 4.0, 4.0
    boxes[1, 28] = [30, 30, 31, 31]
    return boxes, obj, cls, points, strides, gt, classes, mask


def test_simota_assign_matches_jax_exactly_f64():
    args = _dyadic_case()
    with jax.enable_x64(True):
        ref = _jax_simota(*(jnp.asarray(a) for a in args))
    got = tyolox.simota_assign(*(_t(a) for a in args))
    for k in ("fg", "matched_gt", "matched_iou"):
        assert got[k].shape == ref[k].shape == (2, 80), k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    fg, mg = ref["fg"], ref["matched_gt"]
    # the case covers what it says it does
    boxes, _, _, points, _, gt, _, mask = args
    iou = pairwise_iou(_t(gt), _t(boxes)).numpy()
    assert iou[0, 0].sum() == 3 - 1 / 256 and iou[1, 1].sum() == 2 + 1 / 576
    assert fg[0, 26] and fg[0, 18] and not fg[0, 19]  # the tie at the cut
    assert mg[0, 26] == mg[0, 18] == 0  # the duplicate GT 1 never wins
    inside = ((points[:, 0] > 33) & (points[:, 0] < 35)).any()
    assert not inside and fg[0, 36] and not fg[0, 37] and mg[0, 36] == 2
    assert fg[1, 9] and mg[1, 9] == 1 and fg[1, 27] and mg[1, 27] == 1
    assert fg[0].sum() == 3 and fg[1].sum() == 2
    assert (mg[~fg] == 0).all()  # an anchor no GT took reports GT 0
    assert not mask[0, 3] and (iou[0, 3] > 0).any()  # a real padded box


def test_simota_assign_matches_jax_f32():
    """Random f32 boxes and logits at the tiny model's 84 anchors, 8 GT
    slots (2 padded): fg and matched GT equal, matched IoUs 1e-6."""
    rs = np.random.RandomState(12)
    points, strides = jyolox.yolo_grid((64, 64))
    xy = rs.uniform(-8, 8, (2, 84, 2)) + points
    wh = rs.uniform(4, 40, (2, 84, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    obj = rs.randn(2, 84).astype(np.float32)
    cls = rs.randn(2, 84, 4).astype(np.float32)
    c = rs.uniform(8, 56, (2, 8, 2))
    s = rs.uniform(2, 40, (2, 8, 2))
    gt = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    classes = rs.randint(0, 4, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[:, 6:] = False
    args = (boxes, obj, cls, points, strides, gt, classes, mask)
    ref = _jax_simota(*(jnp.asarray(a) for a in args))
    got = tyolox.simota_assign(*(_t(a) for a in args))
    np.testing.assert_array_equal(got["fg"].numpy(), ref["fg"])
    np.testing.assert_array_equal(got["matched_gt"].numpy(),
                                  ref["matched_gt"])
    np.testing.assert_allclose(got["matched_iou"].numpy(),
                               ref["matched_iou"], rtol=0, atol=1e-6)
    assert ref["fg"].sum() > 20


def _step_batch():
    """The reference generator's draw at 64 x 64, 4 classes, 8 slots."""
    return synthetic_detection_batch(2, (64, 64), 4, max_objs=8, seed=3)


def step_both(jmodel, tmodel, from_flax, variables, batch, momentum,
              nesterov=True, weight_decay=YOLO_WEIGHT_DECAY):
    """One train step of a tiny model on both sides with f64 compute over
    f32 parameters (the JAX one jitted), the config's SGD (Nesterov unless
    ``nesterov`` is false, ``weight_decay`` on ndim > 1) at STEP_LR: the JAX
    state and metrics after it, the port's state and metrics, its
    parameters before."""
    with jax.enable_x64(True):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_apply(v, b, train=True):
            return jmodel.apply(v, b, train=train, method=jmodel.loss,
                                mutable=["batch_stats"])

        tx = build_optimizer({"type": "sgd", "momentum": momentum,
                              "nesterov": nesterov,
                              "weight_decay": weight_decay}, STEP_LR)
        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(jstate, jbatch))
    model = from_flax(tmodel, variables).to(memory_format=torch.channels_last)
    tx = skip_nonfinite_updates(sgd(STEP_LR, momentum=momentum,
                                    nesterov=nesterov,
                                    weight_decay=weight_decay))
    state = TrainState.create(model, tx)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model_loss)(
        state, {k: _t(v) for k, v in batch.items()})
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, state=state,
                metrics=metrics, old=old, momentum=momentum,
                nesterov=nesterov, weight_decay=weight_decay)


def check_loss_parts(s, parts):
    metrics, jmetrics = s["metrics"], s["jmetrics"]
    assert set(metrics) == set(jmetrics) == {"loss", "grad_norm", *parts}
    for name in ("loss", "grad_norm") + parts:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)
    assert all(float(jmetrics[k]) > 1e-2 for k in parts)


def check_train_step(s, fresh, from_flax, cancelled=None):
    """The reference's trace after its first step is g + wd * p (its
    gradient, decayed where ndim > 1): every gradient within 1e-5 of its
    largest element; the parameters after the step within 1e-6 plus what
    that gradient tolerance moves them by (the step is -lr (1 + momentum)
    (g + wd p) with Nesterov, -lr (g + wd p) without), the BN running
    statistics within 1e-6. Every parameter the reference's loss reaches
    gets a gradient and moves (a branch that sees no foreground, as YOLOX's
    class branch on a level that takes none, gets none on both sides);
    every statistic moves. With ``cancelled``, a parameter whose reference
    gradient lies under ``cancelled`` times the largest of all the
    gradients is one whose gradient cancels (a BN bias that reaches the
    loss only through a linear layer and another train-mode BN): its
    gradient is rounding noise on both sides, and the port's is held under
    the same bound instead."""
    new, momentum = s["new_jstate"], s["momentum"]
    nesterov, weight_decay = s["nesterov"], s["weight_decay"]
    ref = from_flax(fresh, {"params": new.params,
                            "batch_stats": new.batch_stats})
    opt = sgd(STEP_LR, momentum=momentum, nesterov=nesterov,
              weight_decay=weight_decay).init(ref)
    sgd_state_from_optax(ref, opt, new.opt_state)
    trace = {n: opt.state[p]["momentum_buffer"]
             for n, p in ref.named_parameters()}
    model = s["state"].model
    got = dict(model.named_parameters())
    g_refs = {n: trace[n] - (weight_decay if got[n].ndim > 1 else 0.0)
              * s["old"][n] for n in trace}
    largest = max(float(g.abs().max()) for g in g_refs.values())
    reached = noise = 0
    for name, r in ref.named_parameters():
        p, old, g_ref = got[name], s["old"][name], g_refs[name]
        scale = float(g_ref.abs().max())
        err = float((p.grad - g_ref).abs().max())
        if cancelled is not None and scale < cancelled * largest:
            noise += 1
            assert float(p.grad.abs().max()) < cancelled * largest, name
        else:
            assert err <= 1e-5 * scale, (name, err, scale)
            if scale > 0:
                reached += 1
                assert p.grad.abs().max() > 0, name
                assert (r.detach() - old).abs().max() > 0, name
        np.testing.assert_allclose(
            p.detach().numpy(), r.detach().numpy(), rtol=0,
            atol=1e-6 + STEP_LR * (1 + momentum * nesterov) * 1e-5 * scale,
            err_msg=name)
    bufs = dict(model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
            assert (bufs[name] - (0 if "mean" in name else 1)).abs().max() \
                > 0, name
    assert reached >= 0.9 * (len(got) - noise)


@pytest.fixture(scope="module")
def f64():
    variables = random_variables(_tiny_shapes(), seed=5)
    return step_both(jyolox.YOLOX(**TINY, dtype=jnp.float64),
                     tyolox.YOLOX(**TINY, dtype=torch.float64),
                     yolox_from_flax, variables, _step_batch(),
                     YOLOX_MOMENTUM)


def test_loss_parts_match_jax_f64(f64):
    check_loss_parts(f64, PARTS)


def test_train_step_matches_jax_f64(f64):
    check_train_step(f64, tyolox.YOLOX(**TINY), yolox_from_flax)


@pytest.mark.parametrize("momentum", [YOLOX_MOMENTUM, YOLOV5_MOMENTUM])
def test_sgd_nesterov_matches_optax(momentum):
    """Three steps of Nesterov SGD (decay 5e-4 on ndim > 1 only) at lr
    0.01 against the reference's ``sgd(nesterov=True)``, at both configs'
    momentum: |port - optax| <= 1e-6 + 1e-6 |optax| after each."""
    params, grads = _params_and_grads(np.random.RandomState(2))
    tx = build_optimizer({"type": "sgd", "momentum": momentum,
                          "nesterov": True, "weight_decay": YOLO_WEIGHT_DECAY,
                          "nan_guard": False}, STEP_LR)
    recipe = sgd(STEP_LR, momentum=momentum, nesterov=True,
                 weight_decay=YOLO_WEIGHT_DECAY)
    out, _, opt = _run_both(tx, recipe, params, grads)
    for step, (want, got) in enumerate(out):
        for k in params:
            err = np.abs(got[k] - want[k])
            assert (err <= 1e-6 + 1e-6 * np.abs(want[k])).all(), (step, k)
    assert opt.param_groups[0]["momentum"] == momentum


def _counts(warmup):
    return [0, 1, warmup - 1, warmup, warmup + 1, 1_000_000,
            YOLO_COSINE_TOTAL_STEPS - 1, YOLO_COSINE_TOTAL_STEPS,
            YOLO_COSINE_TOTAL_STEPS + 100_000]


@pytest.mark.parametrize("warmup,count", [
    (w, c) for w in (YOLOX_WARMUP, YOLOV5_WARMUP) for c in _counts(w)])
def test_warmup_cosine_matches_optax(warmup, count):
    """The configs' schedules, ``warmup_cosine(0.01, 2.2e6, 36700)``
    (YOLOX) and ``(0.01, 2.2e6, 22000)`` (YOLOv5), against the reference's
    (``optax.warmup_cosine_decay_schedule``), f32 at the count: 0 at count
    0, 0.01 at the boundary, 0 from the end on."""
    ref = j_warmup_cosine(YOLO_LR, YOLO_COSINE_TOTAL_STEPS, warmup)(
        jnp.asarray(count, jnp.int32))
    direct = optax.warmup_cosine_decay_schedule(
        0.0, YOLO_LR, warmup, YOLO_COSINE_TOTAL_STEPS)(count)
    assert float(ref) == float(direct)
    got = warmup_cosine(YOLO_LR, YOLO_COSINE_TOTAL_STEPS, warmup)(
        torch.tensor(count))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-12)
    if count == 0:
        assert float(got) == 0.0
    if count == warmup:
        assert float(got) == pytest.approx(YOLO_LR, rel=1e-6)


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolox_train_entry()


def test_train_entry_builds_on_cpu_when_asked():
    """``yolox_train_entry`` builds (no step: the full-width model at 640²
    is for the card): f32 parameters, bf16 compute, train mode, the
    reference's score biases (-4.59, uncalibrated); guarded Nesterov SGD
    0.9 with decay 5e-4 on ndim > 1 parameters, no clip, lr 0 at count 0
    of the config's warm-up cosine; the reference's batch with 16
    slots."""
    step_fn, (state, batch) = yolox_train_entry(device="cpu", batch=2)
    model, tx, opt = state.model, state.tx, state.optimizer
    assert callable(step_fn) and model.training
    assert model.dtype == torch.bfloat16 and model.image_hw == (640, 640)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert bool((model.head.obj_out0.bias == -4.59).all())
    assert (tx.momentum, tx.nesterov, tx.weight_decay, tx.clip_global_norm,
            tx.nan_guard) == (0.9, True, 5e-4, None, True)
    decayed, plain = opt.param_groups
    assert all(p.ndim > 1 for p in decayed["params"])
    assert all(p.ndim <= 1 for p in plain["params"])
    assert float(tx.learning_rate(torch.tensor(0))) == 0.0
    assert float(tx.learning_rate(torch.tensor(YOLOX_WARMUP))) == \
        pytest.approx(YOLO_LR)
    assert int(decayed["count"]) == 0
    assert batch["image"].shape == (2, 640, 640, 3)
    want = synthetic_detection_batch(2, (640, 640), 80)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
