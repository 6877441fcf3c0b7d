"""The port's YOLOv8 train path vs the JAX package's, on the CPU.

- ``elementwise_iou`` at 1e-6 (f32) on overlapping, disjoint and empty
  boxes; the BCE with its gradient at a logit of 0.
- ``tal_assign`` (the reference's one-image function under ``vmap``):
  exactly in f64 on boxes of dyadic coordinates (every IoU exact): padded
  slots holding real-looking boxes, an anchor inside two GTs, a GT slot
  duplicated (its metrics tie the other's at every anchor: the first GT
  wins), two anchors whose metrics tie across the top-k cut (the lower
  anchor wins), a GT that holds no anchor point and so matches nothing; at
  top-k 2 and the default 10. In f32 on random boxes: the discrete outputs
  equal, soft targets at 1e-6.
- ``YOLOv8.loss`` and one train step on the tiny model of
  ``test_torch_yolov8.py`` (width 0.125, depth 0.33, 4 classes, 64x64),
  weights through ``yolov8_from_flax``, with the config's SGD (momentum
  0.937, Nesterov, decay 5e-4 on ndim > 1, inside the NaN guard) at a
  constant lr 0.01 (the warm-up's first step has lr 0): with f64 compute
  over f32 parameters (the head's outputs, the assignment and the losses in
  f32 on both sides, as the reference computes them) the three loss parts
  1e-6, every gradient 1e-5 of its largest element, the parameters after
  the step 1e-6 plus the step's share of that gradient tolerance, the BN
  statistics 1e-6; with f32 compute the parts rtol 1e-4, the BN
  statistics 1e-5.
- The optimizer alone against optax: Nesterov SGD with the decay mask over
  three steps, the config's ``linear_warmup`` against the reference's
  ``join_schedules`` at the counts that matter, and the NaN guard against
  ``optax.apply_if_finite`` with an inf or a NaN gradient in the middle
  step (parameters, trace and the schedule's count unchanged).
- The train entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8 import TINY

from minddet_tpu.core.lr_schedules import linear_warmup as j_linear_warmup
from minddet_tpu.core.optim import build_optimizer
from minddet_tpu.models.detectors import yolov8 as jyolo
from minddet_tpu.ops import box as jbox
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch.core.lr_schedules import linear_warmup
from minddet_tpu_torch.core.optim import sgd, skip_nonfinite_updates
from minddet_tpu_torch.entry import (YOLO_END_FACTOR, YOLO_LR, YOLO_MOMENTUM,
                                     YOLO_TOTAL_STEPS, YOLO_WARMUP,
                                     YOLO_WEIGHT_DECAY, model_loss,
                                     yolov8_train_entry)
from minddet_tpu_torch.models.detectors import yolov8 as tyolo
from minddet_tpu_torch.ops.box import elementwise_iou
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import (sgd_state_from_optax,
                                             yolov8_from_flax)

PARTS = ("iou_loss", "cls_loss", "dfl_loss")
STEP_LR = 0.01
SGD_CFG = {"type": "sgd", "momentum": YOLO_MOMENTUM, "nesterov": True,
           "weight_decay": YOLO_WEIGHT_DECAY}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_elementwise_iou_matches_jax():
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 50, (3, 40, 2)).astype(np.float32)
    b1 = np.concatenate([xy, xy + rs.uniform(0, 20, (3, 40, 2))], -1)
    b2 = b1 + rs.uniform(-15, 15, b1.shape).astype(np.float32)
    b2[0, :5] = b1[0, :5] + 100.0  # disjoint
    b2[1, :5, 2:] = b2[1, :5, :2]  # empty
    ref = np.asarray(jbox.elementwise_iou(jnp.asarray(b1), jnp.asarray(b2)))
    got = elementwise_iou(_t(b1), _t(b2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (ref[0, :5] == 0).all() and (ref[1, :5] == 0).all()
    assert ((ref > 0.1) & (ref < 1)).mean() > 0.2


def test_bce_matches_jax_with_its_tie_gradient():
    """``bce_with_logits`` against the reference's ``yolox._bce``, values
    and the gradient to the logits at 1e-6 (f32), logits at exactly 0
    included: there JAX's ``maximum`` passes half of the gradient and its
    ``abs`` has slope 1, so the gradient is -t, and so is the port's."""
    from minddet_tpu.models.detectors.yolox import _bce
    from minddet_tpu_torch.models.losses import bce_with_logits

    rs = np.random.RandomState(3)
    x = (rs.randn(64) * 5).astype(np.float32)
    x[:8] = 0.0
    t = rs.uniform(0, 1, 64).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda a: jnp.sum(_bce(a, t)))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = bce_with_logits(xt, _t(t)).sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[:8], -t[:8], atol=1e-6)


def _jax_tal(*args, topk=10):
    fn = jax.vmap(lambda bx, cl, gb, gc, gm: jyolo.tal_assign(
        bx, cl, args[2], gb, gc, gm, topk=topk))
    return jax.device_get(jax.jit(fn)(args[0], args[1], *args[3:]))


def _dyadic_case():
    """Two images over a 4 x 4 grid of anchor points (stride 8 on 32 x
    32), predicted boxes of dyadic coordinates. Image 0: GT 0 holds six
    points; anchor 5 predicts it exactly, anchors 2 and 6 predict the same
    box with the same logits (their metrics tie); GT 1 duplicates GT 0;
    GT 2 lies between the points; GT 3 is padding. Image 1: GTs 0 and 1
    share the point (12, 12), whose anchor 5 predicts a box near GT 1 and
    is GT 0's best (GT 0's other anchors predict tiny boxes); GTs 2 and 3
    are padding with real boxes."""
    rs = np.random.RandomState(11)
    g = (np.arange(4) + 0.5) * 8
    ys, xs = np.meshgrid(g, g, indexing="ij")
    points = np.stack([xs.ravel(), ys.ravel()], -1)
    half = rs.randint(4, 25, (2, 16, 2)) / 2.0
    centre = points + rs.randint(-12, 13, (2, 16, 2)) / 4.0
    boxes = np.concatenate([centre - half, centre + half], -1)
    logits = rs.randn(2, 16, 3)
    gt = np.array([[[2, 2, 22, 14], [2, 2, 22, 14], [13, 13, 19, 19],
                    [0, 0, 32, 32]],
                   [[0, 0, 16, 16], [8, 8, 32, 32], [0, 0, 8, 8],
                    [4, 4, 30, 30]]], np.float64)
    classes = np.array([[1, 1, 0, 2], [0, 2, 1, 1]], np.int32)
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    boxes[0, 5] = gt[0, 0]
    boxes[0, 6] = boxes[0, 2] = [6.5, 1.0, 22.0, 15.5]
    logits[0, 6] = logits[0, 2]
    boxes[1, 5] = [8.0, 8.0, 30.0, 30.0]
    for i in (0, 1, 4):
        boxes[1, i] = np.concatenate([points[i] - 0.5, points[i] + 0.5])
    return boxes, logits, points, gt, classes, mask


@pytest.mark.parametrize("topk", [2, 10])
def test_tal_assign_matches_jax_exactly_f64(topk):
    args = _dyadic_case()
    with jax.enable_x64(True):
        ref = _jax_tal(*(jnp.asarray(a) for a in args), topk=topk)
    got = tyolo.tal_assign(*(_t(a) for a in args), topk=topk)
    for k in ("fg", "matched_gt", "soft_target"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    fg, mg = ref["fg"], ref["matched_gt"]
    # the case covers what it says it does
    metric, _ = tyolo.align_metric(*(_t(a) for a in args))
    assert float(metric[0, 0, 2]) == float(metric[0, 0, 6]) > 0
    assert torch.equal(metric[0, 0], metric[0, 1])
    if topk == 2:
        assert fg[0, 5] and fg[0, 2] and not fg[0, 6]
    assert (mg[0][fg[0]] == 0).all()  # the duplicate GT never wins
    assert float(metric[0, 2].abs().max()) == 0  # GT 2 holds no point
    assert float(metric[0, 3].abs().max()) == 0  # padding
    assert float(metric[1, 2:].abs().max()) == 0
    shared = 1 * 4 + 1  # the point (12, 12)
    assert 0 < float(metric[1, 0, shared]) < float(metric[1, 1, shared])
    assert int(metric[1, 0].argmax()) == shared
    assert fg[1, shared] and mg[1, shared] == 1
    assert 0 < ref["soft_target"][fg].min()
    assert (ref["soft_target"][~fg] >= 0).all()


def test_tal_assign_matches_jax_f32():
    """Random f32 boxes and logits at the tiny model's 84 anchors, 8 GT
    slots (2 padded): fg and matched GT equal, soft targets 1e-6."""
    rs = np.random.RandomState(12)
    points, _ = tyolo.yolo_grid((64, 64))
    xy = rs.uniform(-8, 8, (2, 84, 2)) + points
    wh = rs.uniform(4, 40, (2, 84, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    logits = rs.randn(2, 84, 4).astype(np.float32)
    c = rs.uniform(8, 56, (2, 8, 2))
    s = rs.uniform(6, 40, (2, 8, 2))
    gt = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    classes = rs.randint(0, 4, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    mask[:, 6:] = False
    args = (boxes, logits, points, gt, classes, mask)
    ref = _jax_tal(*(jnp.asarray(a) for a in args))
    got = tyolo.tal_assign(*(_t(a) for a in args))
    np.testing.assert_array_equal(got["fg"].numpy(), ref["fg"])
    np.testing.assert_array_equal(got["matched_gt"].numpy(),
                                  ref["matched_gt"])
    np.testing.assert_allclose(got["soft_target"].numpy(),
                               ref["soft_target"], rtol=0, atol=1e-6)
    assert ref["fg"].sum() > 20


def _step_batch():
    """The reference generator's draw at 64 x 64, 4 classes, 8 slots."""
    return synthetic_detection_batch(2, (64, 64), 4, max_objs=8, seed=3)


def _variables():
    """The tiny model's numpy-random variables, the DFL biases falling by
    0.7 a bin so that the decoded sides start near one stride (boxes of the
    GTs' size) and the assignment finds overlaps."""
    jm = jyolo.YOLOv8(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    v = random_variables({k: dict(v) for k, v in shapes.items()}, seed=5)
    head = v["params"]["head"]
    for i in range(3):
        head[f"reg_out{i}"]["bias"] = np.tile(
            -0.7 * np.arange(16, dtype=np.float32), 4)
    return v


def _setup(compute):
    """One train step of the tiny model on both sides with ``compute`` as
    the compute dtype over f32 parameters (the JAX one jitted)."""
    batch = _step_batch()
    variables = _variables()
    with jax.enable_x64(compute == "float64"):
        jm = jyolo.YOLOv8(**TINY, dtype=jnp.dtype(compute))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_apply(v, b, train=True):
            return jm.apply(v, b, train=train, method=jm.loss,
                            mutable=["batch_stats"])

        tx = build_optimizer(SGD_CFG, STEP_LR)
        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(jstate, jbatch))
    model = yolov8_from_flax(tyolo.YOLOv8(**TINY,
                                          dtype=getattr(torch, compute)),
                             variables)
    model = model.to(memory_format=torch.channels_last)
    tx = skip_nonfinite_updates(sgd(STEP_LR, momentum=YOLO_MOMENTUM,
                                    nesterov=True,
                                    weight_decay=YOLO_WEIGHT_DECAY))
    state = TrainState.create(model, tx)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model_loss)(
        state, {k: _t(v) for k, v in batch.items()})
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, state=state,
                metrics=metrics, old=old)


@pytest.fixture(scope="module")
def f64():
    return _setup("float64")


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def test_loss_parts_match_jax_f64(f64):
    metrics, jmetrics = f64["metrics"], f64["jmetrics"]
    assert set(metrics) == set(jmetrics) == {"loss", "grad_norm", *PARTS}
    for name in ("loss", "grad_norm") + PARTS:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)
    assert all(float(jmetrics[k]) > 1e-2 for k in PARTS)


def test_loss_parts_match_jax_f32(f32):
    """f32 compute: rtol 1e-4 (some 60 f32 conv layers summed in another
    order than XLA's)."""
    for name in ("loss", "grad_norm") + PARTS:
        np.testing.assert_allclose(float(f32["metrics"][name]),
                                   float(f32["jmetrics"][name]), rtol=1e-4,
                                   err_msg=name)


def _reference(s):
    """The JAX state after its step, carried into a fresh port model with
    an optimizer holding its trace (``sgd_state_from_optax``)."""
    new = s["new_jstate"]
    ref = yolov8_from_flax(tyolo.YOLOv8(**TINY), {
        "params": new.params, "batch_stats": new.batch_stats})
    opt = sgd(STEP_LR, momentum=YOLO_MOMENTUM, nesterov=True,
              weight_decay=YOLO_WEIGHT_DECAY).init(ref)
    sgd_state_from_optax(ref, opt, new.opt_state)
    return ref, {n: opt.state[p]["momentum_buffer"]
                 for n, p in ref.named_parameters()}


def test_train_step_matches_jax_f64(f64):
    """One guarded Nesterov SGD step with f64 compute. The reference's
    trace after its first step is g + wd * p (its gradient, decayed where
    ndim > 1): every gradient within 1e-5 of its largest element; the
    parameters after the step within 1e-6 plus what that gradient
    tolerance moves them by (the step is -lr (1 + momentum) (g + wd p)),
    the BN running statistics within 1e-6. Every parameter gets a gradient
    and moves."""
    model = f64["state"].model
    ref, trace = _reference(f64)
    got = dict(model.named_parameters())
    for name, r in ref.named_parameters():
        p, old = got[name], f64["old"][name]
        decay = YOLO_WEIGHT_DECAY if p.ndim > 1 else 0.0
        g_ref = trace[name] - decay * old
        assert p.grad is not None and p.grad.abs().max() > 0, name
        scale = float(g_ref.abs().max())
        err = float((p.grad - g_ref).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
        assert (r.detach() - old).abs().max() > 0, name
        np.testing.assert_allclose(
            p.detach().numpy(), r.detach().numpy(), rtol=0,
            atol=1e-6 + STEP_LR * (1 + YOLO_MOMENTUM) * 1e-5 * scale,
            err_msg=name)
    bufs = dict(model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
            assert (bufs[name] - (0 if "mean" in name else 1)).abs().max() \
                > 0, name


def test_train_step_statistics_match_jax_f32(f32):
    ref, _ = _reference(f32)
    bufs = dict(f32["state"].model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for name, value in params.items():
            setattr(self, name, torch.nn.Parameter(_t(value)))


def _run_both(tx_ref, recipe, params, grads):
    """The steps of an optax transformation and of the port's recipe on the
    same gradients; returns, after each, both sides' parameters and the
    port's optimizer."""
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx_ref.init(jparams)
    model = _Params(params)
    opt = recipe.init(model)
    out = []
    for g in grads:
        updates, jstate = tx_ref.update({k: jnp.asarray(v)
                                         for k, v in g.items()},
                                        jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad(set_to_none=True)
        for name, value in g.items():
            getattr(model, name).grad = _t(value)
        recipe.update(opt, model.parameters())
        out.append(({k: np.asarray(v) for k, v in jparams.items()},
                    {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()}))
    return out, model, opt


def _params_and_grads(rs):
    params = {"w": rs.randn(6, 5).astype(np.float32),
              "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (1.0, 3.0, 0.5)]
    return params, grads


def test_sgd_nesterov_matches_optax():
    """Three steps of Nesterov SGD (momentum 0.937, decay 5e-4 on ndim > 1
    only) at lr 0.01 against the reference's ``sgd(nesterov=True)``:
    |port - optax| <= 1e-6 + 1e-6 |optax| after each."""
    params, grads = _params_and_grads(np.random.RandomState(0))
    tx = build_optimizer(dict(SGD_CFG, nan_guard=False), STEP_LR)
    recipe = sgd(STEP_LR, momentum=YOLO_MOMENTUM, nesterov=True,
                 weight_decay=YOLO_WEIGHT_DECAY)
    out, _, _ = _run_both(tx, recipe, params, grads)
    for step, (want, got) in enumerate(out):
        for k in params:
            err = np.abs(got[k] - want[k])
            assert (err <= 1e-6 + 1e-6 * np.abs(want[k])).all(), (step, k)
    # Nesterov differs from the plain trace from the first step on
    plain, _, _ = _run_both(
        build_optimizer(dict(SGD_CFG, nesterov=False, nan_guard=False),
                        STEP_LR),
        sgd(STEP_LR, momentum=YOLO_MOMENTUM, weight_decay=YOLO_WEIGHT_DECAY),
        params, grads[:1])
    assert np.abs(plain[0][1]["w"] - out[0][1]["w"]).max() > 1e-3


@pytest.mark.parametrize("count", [0, 1, 2, 21999, 22000, 22001, 1_000_000,
                                   3_599_999, 3_600_000, 4_000_000])
def test_linear_warmup_matches_optax(count):
    """The config's schedule, ``linear_warmup(0.01, 22000, 3.6e6, 0.01)``,
    against the reference's (``optax.join_schedules`` of two
    ``linear_schedule``s), f32 at the count: 0 at count 0, 0.01 at the
    boundary, 1e-4 from the end on."""
    ref = j_linear_warmup(YOLO_LR, YOLO_WARMUP, YOLO_TOTAL_STEPS,
                          YOLO_END_FACTOR)(jnp.asarray(count, jnp.int32))
    got = linear_warmup(YOLO_LR, YOLO_WARMUP, YOLO_TOTAL_STEPS,
                        YOLO_END_FACTOR)(torch.tensor(count))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=0)
    if count == 0:
        assert float(got) == 0.0


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_nan_guard_matches_apply_if_finite(bad):
    """The reference's ``build_optimizer`` (``skip_nonfinite_updates``
    around Nesterov SGD with decay under a short warm-up, 0 -> 0.01 over 2
    counts) against the port's guarded recipe over three steps whose middle
    one has a non-finite gradient: the parameters after each step within
    1e-6 of optax's; the middle step changes no parameter, no trace and not
    the schedule's count, so the last step takes the second count's lr."""
    params, grads = _params_and_grads(np.random.RandomState(1))
    grads[1]["b"][3] = bad
    tx = build_optimizer(SGD_CFG, j_linear_warmup(0.01, 2, 10, 0.01))
    recipe = skip_nonfinite_updates(sgd(
        linear_warmup(0.01, 2, 10, 0.01), momentum=YOLO_MOMENTUM,
        nesterov=True, weight_decay=YOLO_WEIGHT_DECAY))
    out, model, opt = _run_both(tx, recipe, params, grads[:2])
    traces = {k: opt.state[p]["momentum_buffer"].clone()
              for k, p in model.named_parameters()}
    assert int(opt.param_groups[0]["count"]) == 1
    for k in params:
        np.testing.assert_array_equal(out[1][1][k], out[0][1][k])
    out, model, opt = _run_both(tx, recipe, params, grads)
    for step, (want, got) in enumerate(out):
        for k in params:
            err = np.abs(got[k] - want[k])
            assert (err <= 1e-6 + 1e-6 * np.abs(want[k])).all(), (step, k)
    assert int(opt.param_groups[0]["count"]) == 2
    assert all(torch.isfinite(v).all() for v in traces.values())
    assert np.abs(out[2][1]["w"] - out[1][1]["w"]).max() > 1e-4


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov8_train_entry()


def test_train_entry_builds_on_cpu_when_asked():
    """``yolov8_train_entry`` builds (no step: the full-width model at 640²
    is for the card): f32 parameters, bf16 compute, train mode; guarded
    Nesterov SGD 0.937 with decay 5e-4 on ndim > 1 parameters, no clip,
    lr 0 at count 0 of the config's warm-up; the reference's batch with 16
    slots."""
    step_fn, (state, batch) = yolov8_train_entry(device="cpu", batch=2)
    model, tx, opt = state.model, state.tx, state.optimizer
    assert callable(step_fn) and model.training
    assert model.dtype == torch.bfloat16 and model.image_hw == (640, 640)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (tx.momentum, tx.nesterov, tx.weight_decay, tx.clip_global_norm,
            tx.nan_guard) == (0.937, True, 5e-4, None, True)
    decayed, plain = opt.param_groups
    assert all(p.ndim > 1 for p in decayed["params"])
    assert all(p.ndim <= 1 for p in plain["params"])
    assert (decayed["weight_decay"], plain["weight_decay"]) == (5e-4, 0.0)
    assert float(tx.learning_rate(torch.tensor(0))) == 0.0
    assert float(tx.learning_rate(torch.tensor(YOLO_WARMUP))) == \
        pytest.approx(YOLO_LR)
    assert int(decayed["count"]) == 0
    assert batch["image"].shape == (2, 640, 640, 3)
    assert batch["gt_boxes"].shape == (2, 16, 4)
    want = synthetic_detection_batch(2, (640, 640), 80)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
