"""The port's YOLOv3 train path vs the JAX package's, on the CPU, and the
train entries' settings.

- The targets: the reference's loss runs on given head outputs (a test
  subclass whose ``__call__`` returns them), jitted, with ``jax.vmap``
  recorded, so that its own one-image ``level_targets`` and ``ignore``
  report what they computed. In f64 on dyadic boxes at 64 x 64 (levels of
  2, 4 and 8 cells), the head's box outputs at 0 (every prediction the
  anchor's own box at its cell's centre): each GT's best anchor of the
  nine (a zero-width GT ties at IoU 0 on every anchor: the first wins),
  each level's pos / tbox / tcls and the ignore mask, exactly. The case has two GTs on one slot (the later
  wins), a masked GT in the padding with a real box, a GT past the image
  (level 0), a centre past the map's edge (clipped), a prediction at IoU
  exactly 0.5 with a GT (not ignored: the test is strict) and one at IoU 1
  with a masked GT (masked GTs read 0).
- ``loss_from_outputs`` on random head outputs in f64: the loss and its
  parts 1e-12, the gradients to the outputs 1e-10 of their largest.
- One train step of YOLOv3 (4 classes, 96 x 96, batch 1, GTs on every
  level) with f64 compute over f32 parameters and the config's SGD
  (momentum 0.9 without Nesterov, decay 5e-4) at a constant lr 0.01: the
  loss parts 1e-6, every gradient 1e-5 of its largest element, the
  parameters after the step and the BN statistics 1e-6
  (``test_torch_yolox_train.py``'s checks).
- ``multi_epochs_decay`` against optax's f32 values at the counts around
  each boundary, with and without a warm-up.
- The train entries: YOLOv3's, and the settings every 2D detector's train
  entry builds (YOLOv8, YOLOX and YOLOv5 as before the program took its
  settings as arguments).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolox_train import (check_loss_parts, check_train_step,
                                    step_both)

from minddet_tpu.core.lr_schedules import \
    multi_epochs_decay as j_multi_epochs_decay
from minddet_tpu.models.detectors import yolov3 as jyolov3
from minddet_tpu_torch import entry
from minddet_tpu_torch.core.lr_schedules import multi_epochs_decay
from minddet_tpu_torch.models.detectors import yolov3 as tyolov3
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import yolov3_from_flax

LEVEL_HW = (2, 4, 8)  # strides 32, 16, 8 at 64 x 64
PARTS = tuple(f"l{i}_{k}" for i in range(3) for k in ("obj", "box"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


class VmapRecorder:
    """``jax`` as a reference module sees it, with ``vmap`` recording each
    mapped function's name, arguments and results."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*xs):
            out = mapped(*xs)
            self.calls.append((fn.__name__, xs, out))
            return out

        return run


def record_vmaps(module, monkeypatch, fn, *args, jit=True):
    """Run ``fn(*args)``, jitted unless ``jit`` is false, with ``module``'s
    ``jax`` a ``VmapRecorder``: [(name, arguments, results)] of every
    ``vmap``ped function it ran, as numpy arrays. (Jitted, XLA may turn a
    division by a constant into a product with its reciprocal.)"""
    rec = VmapRecorder()
    monkeypatch.setattr(module, "jax", rec)

    def run(*a):
        rec.calls.clear()
        fn(*a)
        return [(xs, out) for _, xs, out in rec.calls]

    values = jax.device_get((jax.jit(run) if jit else run)(*args))
    monkeypatch.undo()
    return [(name, xs, out) for (name, _, _), (xs, out)
            in zip(rec.calls, values)]


class _GivenOutputs(jyolov3.YOLOv3):
    """The reference's YOLOv3 whose forward returns the head outputs passed
    as the image: its ``loss`` on given outputs."""

    def __call__(self, image, train=False):
        return list(image)


def _dyadic_case():
    """Two images at 64 x 64, 7 GT slots; the slot (y, x, a) of a level of
    w cells is (y w + x) 3 + a."""
    gt = np.array([
        [[4, 4, 12, 12],      # 8 x 8: anchor 6 (level 2, a 0), cell (1, 1)
         [6, 6, 14, 14],      # the same slot, later: wins
         [10, 2, 50, 62],     # 40 x 60: anchor 3 (level 1, a 0), cell (2, 1)
         [-30, -20, 86, 70],  # anchor 0's own size past the image: cell 0
         [20, 20, 20, 40],    # zero width: a tie at 0, anchor 0, GT 3's slot
         [60, 60, 68, 68],    # centre 8 cells in: clipped into cell (7, 7)
         [4, 4, 12, 12]],     # padding with a real box
        [[-1, -2.5, 4, 10.5],  # IoU exactly 1/2 with level 2's (0, 0, 0)
         [-1, -2.5, 9, 10.5],  # that prediction itself, masked
         [16, 16, 48, 48],     # 32 x 32: anchor 8 (level 2, a 2), cell (4, 4)
         [16, 16, 48, 48],     # a copy of another class: wins
         [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float64)
    classes = np.array([[1, 2, 3, 0, 1, 2, 3], [0, 2, 3, 1, 0, 0, 0]],
                       np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 1, 0], [1, 0, 1, 1, 0, 0, 0]], bool)
    return dict(gt_boxes=gt, gt_classes=classes, gt_mask=mask)


def _outputs(rs, batch=2, hws=LEVEL_HW, box_zero=False):
    outs = [rs.randn(batch, h, h, 3, 9) for h in hws]
    if box_zero:
        for o in outs:
            o[..., :4] = 0.0
    return outs


def _reference_targets(outs, gt, monkeypatch):
    """The reference's loss on ``outs`` in f64: each level's (ba, tobj,
    tbox, tcls) from ``level_targets`` and the ignore mask from
    ``ignore``."""
    jm = _GivenOutputs(num_classes=4, image_hw=(64, 64))
    with jax.enable_x64(True):
        calls = record_vmaps(
            jyolov3, monkeypatch, lambda o, g: jm.apply(
                {}, dict(image=o, **g), method=jm.loss),
            tuple(jnp.asarray(o) for o in outs),
            {k: jnp.asarray(v) for k, v in gt.items()})
    targets = [(args[3],) + tuple(out) for name, args, out in calls
               if name == "level_targets"]
    ignores = [out for name, _, out in calls if name == "ignore"]
    assert len(targets) == len(ignores) == 3
    return targets, ignores


def test_targets_and_ignore_match_jax_exactly_f64(monkeypatch):
    gt = _dyadic_case()
    outs = _outputs(np.random.RandomState(0), box_zero=True)
    targets, ignores = _reference_targets(outs, gt, monkeypatch)
    tm = tyolov3.YOLOv3(num_classes=4, image_hw=(64, 64))
    tg = {k: _t(v) for k, v in gt.items()}
    (all_wh,) = tm.all_anchor_wh("cpu")
    best = tyolov3.best_anchor(tg["gt_boxes"], all_wh)
    np.testing.assert_array_equal(best.numpy(), targets[0][0])
    assert best[0].tolist() == [6, 6, 3, 0, 0, 6, 6]
    assert best[1, :4].tolist() == [6, 6, 8, 8]
    for li, ((_, tobj, tbox, tcls), ign) in enumerate(zip(targets, ignores)):
        hw = LEVEL_HW[li]
        pos, box, cls = tyolov3.yolov3_targets(
            tg["gt_boxes"], tg["gt_classes"], tg["gt_mask"], best, li,
            tyolov3.STRIDES[li], (hw, hw))
        boxes = tm.decode_level(_t(outs[li]), li)[0]
        got_ign = tyolov3.ignore_mask(boxes, tg["gt_boxes"], tg["gt_mask"],
                                      tyolov3.IGNORE_IOU)
        for g, r, name in ((pos, tobj, "pos"), (box, tbox, "tbox"),
                           (cls, tcls, "tcls"), (got_ign, ign, "ignore")):
            assert tuple(g.shape) == r.shape, (li, name)
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{li} {name}")
        assert cls.dtype == torch.int32 and pos.dtype == torch.float64
    # the case covers what it says it does
    (_, p0, b0, c0), (_, p1, _, c1), (_, p2, b2, c2) = targets
    assert p0[0, 0] == 1 and c0[0, 0] == 1 and p0[0].sum() == 1
    np.testing.assert_array_equal(b0[0, 0], gt["gt_boxes"][0, 4])
    assert p1[0, (2 * 4 + 1) * 3] == 1 and c1[0, (2 * 4 + 1) * 3] == 3
    assert c2[0, (1 * 8 + 1) * 3] == 2 and p2[0].sum() == 2
    assert p2[0, (7 * 8 + 7) * 3] == 1
    assert c2[1, (4 * 8 + 4) * 3 + 2] == 1 and p2[1].sum() == 2
    assert p2[1, 0] == 1 and not ignores[2][1, 0]  # IoU 1/2 exactly
    iou = tyolov3.pairwise_iou(tm.decode_level(_t(outs[2]), 2)[0][1, :1],
                               tg["gt_boxes"][1, :2])
    assert iou.tolist() == [[0.5, 1.0]]
    assert ignores[2][1].any() and not ignores[2][1].all()


def _loss_batch():
    return {k: v for k, v in _dyadic_case().items()}


def test_loss_on_given_outputs_matches_jax_f64():
    """Random head outputs (f64): the loss and its six parts within 1e-12,
    the gradients of the loss to every level's outputs within 1e-10 of
    their largest."""
    gt = _loss_batch()
    outs = _outputs(np.random.RandomState(1))
    jm = _GivenOutputs(num_classes=4, image_hw=(64, 64))
    with jax.enable_x64(True):
        def loss(o):
            total, parts = jm.apply(
                {}, dict(image=o, **{k: jnp.asarray(v)
                                     for k, v in gt.items()}),
                method=jm.loss)
            return total, parts

        (total, parts), grads = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(tuple(jnp.asarray(o) for o in outs)))
    tm = tyolov3.YOLOv3(num_classes=4, image_hw=(64, 64))
    touts = [_t(o).requires_grad_(True) for o in outs]
    got, got_parts = tm.loss_from_outputs(
        touts, {k: _t(v) for k, v in gt.items()})
    got.backward()
    assert set(got_parts) == set(parts) == set(PARTS)
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-12)
    for k in PARTS:
        np.testing.assert_allclose(got_parts[k].item(), float(parts[k]),
                                   rtol=1e-12, atol=1e-300, err_msg=k)
        assert float(parts[k]) > 1e-2, k
    for t, r in zip(touts, grads):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())


TRAIN_RES = 96


def _train_batch():
    """96 x 96 (levels of 3, 6 and 12 cells), batch 1: a GT on each level
    (92 x 82 on level 0, 50 x 60 on level 1, two on level 2) and a padded
    slot with a real box."""
    rs = np.random.RandomState(4)
    gt = np.array([[[2, 4, 94, 86], [10, 10, 60, 70], [40, 50, 56, 70],
                    [60, 8, 72, 24], [4, 4, 12, 12], [0, 0, 0, 0]]],
                  np.float32)
    return dict(image=rs.rand(1, TRAIN_RES, TRAIN_RES, 3).astype(np.float32),
                gt_boxes=gt, gt_classes=np.array([[1, 3, 0, 2, 1, 0]],
                                                 np.int32),
                gt_mask=np.array([[1, 1, 1, 1, 0, 0]], bool))


@pytest.fixture(scope="module")
def f64():
    shape = dict(num_classes=4, image_hw=(TRAIN_RES, TRAIN_RES))
    jm = jyolov3.YOLOv3(**shape)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, TRAIN_RES, TRAIN_RES, 3))))
    variables = random_variables({k: dict(v) for k, v in shapes.items()}, 12)
    return step_both(jyolov3.YOLOv3(**shape, dtype=jnp.float64),
                     tyolov3.YOLOv3(**shape, dtype=torch.float64),
                     yolov3_from_flax, variables, _train_batch(),
                     entry.YOLOV3_MOMENTUM, nesterov=False)


def test_loss_parts_match_jax_f64(f64):
    check_loss_parts(f64, PARTS)


def test_train_step_matches_jax_f64(f64):
    check_train_step(f64, tyolov3.YOLOv3(num_classes=4,
                                         image_hw=(TRAIN_RES, TRAIN_RES)),
                     yolov3_from_flax)


def _boundaries(steps_per_epoch, milestones, warmup):
    counts = [0, 1, 1000]
    for m in milestones:
        b = warmup + m * steps_per_epoch
        counts += [b - 1, b, b + 1]
    if warmup:
        counts += [warmup // 2, warmup - 1, warmup, warmup + 1]
    return counts


@pytest.mark.parametrize("warmup,count", [
    (w, c) for w in (0, 500) for c in _boundaries(
        entry.YOLOV3_STEPS_PER_EPOCH, entry.YOLOV3_MILESTONES, w)])
def test_multi_epochs_decay_matches_optax(warmup, count):
    """YOLOv3's ``multi_epochs_decay(1e-3, (218, 246), 1833)``, and the same
    after a 500-step warm-up, against the reference's (optax's
    ``piecewise_constant_schedule`` joined to its ``linear_schedule``): the
    same f32 value at the count; 1e-3, 1e-4 and 1e-5 around the
    milestones."""
    args = (entry.YOLOV3_LR, entry.YOLOV3_MILESTONES,
            entry.YOLOV3_STEPS_PER_EPOCH)
    ref = j_multi_epochs_decay(*args, warmup_steps=warmup)(
        jnp.asarray(count, jnp.int32))
    got = multi_epochs_decay(*args, warmup_steps=warmup)(torch.tensor(count))
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert float(got) == float(ref), (float(got), float(ref))
    if count == warmup + 246 * 1833:
        assert float(got) == pytest.approx(1e-5, rel=1e-6)
    if warmup and count < warmup:
        direct = optax.linear_schedule(0.0, entry.YOLOV3_LR, warmup)(count)
        assert float(got) == float(direct)


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.yolov3_train_entry()


# every 2D detector's train entry: (model class, resolution, momentum,
# Nesterov, weight decay, the lr at counts 0, 1000 and 420,000)
TRAIN_ENTRIES = {
    "yolov8": ("YOLOv8", 640, 0.937, True, 5e-4,
               (0.0, 0.01 * 1000 / 22000, None)),
    "yolox": ("YOLOX", 640, 0.9, True, 5e-4,
              (0.0, 0.01 * 1000 / 36700, None)),
    "yolov5": ("YOLOv5", 640, 0.937, True, 5e-4,
               (0.0, 0.01 * 1000 / 22000, None)),
    "yolov3": ("YOLOv3", 416, 0.9, False, 5e-4, (1e-3, 1e-3, 1e-4)),
    "yolov4": ("YOLOv4", 512, 0.949, False, 5e-4,
               (0.0, 1.3e-3 * 1000 / 8000, None)),
    "yolov7": ("YOLOv7", 640, 0.937, True, 5e-4,
               (0.0, 0.01 * 1000 / 22000, None)),
    "ssd": ("SSD", 300, 0.9, False, 4e-5, (0.0, 0.05 * 1000 / 4000, None)),
}


@pytest.mark.parametrize("name", sorted(TRAIN_ENTRIES))
def test_train_entry_settings(name):
    """Each train entry builds (no step) its config's program: the model
    in train mode with f32 parameters and bf16 compute at the config's
    resolution, the guarded SGD with the config's momentum, Nesterov and
    weight decay, no clip, the schedule's lr at counts 0 and 1000 (and
    YOLOv3's past its first milestone), the reference generator's batch at
    the resolution. YOLOv8's, YOLOX's and YOLOv5's are the settings they
    had before ``_yolo_train_program`` took them as arguments."""
    cls, res, momentum, nesterov, decay, lrs = TRAIN_ENTRIES[name]
    step_fn, (state, batch) = getattr(entry, f"{name}_train_entry")(
        device="cpu", batch=2)
    model, tx = state.model, state.tx
    assert callable(step_fn) and model.training
    assert type(model).__name__ == cls and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    size = model.image_size if name == "ssd" else model.image_hw[0]
    assert size == res
    assert (tx.momentum, tx.nesterov, tx.weight_decay, tx.clip_global_norm,
            tx.nan_guard) == (momentum, nesterov, decay, None, True)
    opt = state.optimizer
    assert [g["weight_decay"] for g in opt.param_groups] == [decay, 0.0]
    assert all(g["nesterov"] == nesterov for g in opt.param_groups)
    for count, want in zip((0, 1000, 420_000), lrs):
        if want is not None:
            assert float(tx.learning_rate(torch.tensor(count))) == \
                pytest.approx(want, rel=1e-5, abs=1e-12), count
    want = synthetic_detection_batch(2, (res, res), 80)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
