"""The port's YOLOv5 train path vs the JAX package's, on the CPU.

- ``elementwise_ciou``: values and the gradients to both boxes in f64
  (1e-12, 1e-10 of the largest) on overlapping, nested, identical,
  disjoint and zero-size boxes; alpha is detached on both sides.
- ``yolov5_assign`` (the reference's one-image function under ``vmap``),
  exactly in f64 on one level (stride 8, 4 x 4 cells, three anchors of
  power-of-two sides) with boxes of dyadic coordinates: a centre at half a
  cell (the neighbour test ``offset < 0.5`` is false there), a width ratio
  of exactly 4 (the gate ``< 4`` shuts), a later GT whose slots overlap an
  earlier one's (the last writer in (GT, cell, anchor) order wins, as the
  reference's ``.at[].set`` on the CPU), a GT's neighbour cell that is an
  earlier GT's centre cell, neighbours off the map, a centre past the
  map's edge (clipped to w - 1e-3), padded slots holding real boxes; and
  at each level of the full-size model on the reference generator's boxes
  (YOLOV5_ANCHORS, f32).
- ``YOLOv5.loss`` and one train step of the tiny model of
  ``test_torch_yolov5.py`` (width 0.125, depth 0.33, 4 classes, 64x64),
  weights through ``yolov5_from_flax``, with the config's SGD (momentum
  0.937, Nesterov, decay 5e-4 on ndim > 1, inside the NaN guard) at a
  constant lr 0.01: with f64 compute over f32 parameters the three loss
  parts 1e-6, every gradient 1e-5 of its largest element, the parameters
  after the step 1e-6 plus the step's share of that gradient tolerance,
  the BN statistics 1e-6 (``test_torch_yolox_train.py``'s checks).
- The train entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov5 import TINY, _tiny_shapes
from test_torch_yolox_train import (_step_batch, check_loss_parts,
                                    check_train_step, step_both)

from minddet_tpu.models.detectors import yolov5 as jyolov5
from minddet_tpu.ops import box as jbox
from minddet_tpu_torch.entry import (YOLO_LR, YOLOV5_MOMENTUM, YOLOV5_WARMUP,
                                     yolov5_train_entry)
from minddet_tpu_torch.models.detectors import yolov5 as tyolov5
from minddet_tpu_torch.ops.box import elementwise_ciou
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import yolov5_from_flax

PARTS = ("box_loss", "obj_loss", "cls_loss")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ciou_boxes():
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 50, (3, 40, 2))
    b1 = np.concatenate([xy, xy + rs.uniform(1, 20, (3, 40, 2))], -1)
    b2 = b1 + rs.uniform(-15, 15, b1.shape)
    b2[0, :5] = b1[0, :5] + 100.0  # disjoint
    b2[1, :5] = b1[1, :5]  # identical
    b2[1, 5:10, :2] = b1[1, 5:10, :2] + 0.5  # nested
    b2[1, 5:10, 2:] = b1[1, 5:10, 2:] - 0.5
    b2[2, :5, 2:] = b2[2, :5, :2]  # zero-size
    return b1, b2


def test_elementwise_ciou_matches_jax_f64():
    """Values within 1e-12 and the gradients of their sum to both boxes
    within 1e-10 of the largest."""
    b1, b2 = _ciou_boxes()
    with jax.enable_x64(True):
        want, (g1, g2) = jax.jit(jax.vmap(jax.vmap(jax.value_and_grad(
            jbox.elementwise_ciou, (0, 1)))))(jnp.asarray(b1),
                                              jnp.asarray(b2))
        want = np.asarray(want)
    t1, t2 = _t(b1).requires_grad_(True), _t(b2).requires_grad_(True)
    got = elementwise_ciou(t1, t2)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-12)
    for g, r in ((t1.grad, g1), (t2.grad, g2)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())
    np.testing.assert_allclose(want[1, :5], 1.0, atol=1e-15)
    assert (want[0, :5] < 0).all() and np.isfinite(want).all()


def _jax_assign(gt, classes, mask, anchors_wh, stride, hw):
    fn = jax.vmap(lambda gb, gc, gm: jyolov5.yolov5_assign(
        gb, gc, gm, anchors_wh, stride, hw))
    return jax.device_get(jax.jit(fn)(gt, classes, mask))


ANCHORS = ((8.0, 8.0), (16.0, 8.0), (32.0, 32.0))


def _dyadic_case():
    """Two images on one level: stride 8, 4 x 4 cells (32 x 32), anchors
    ``ANCHORS``; slot (y, x, a) is y * 12 + x * 3 + a."""
    gt = np.array([
        # centre (12, 12): cell (1, 1) at half a cell, neighbours (1, 2)
        # and (2, 1); sides 8: anchor 2's ratio is exactly 4
        [[8, 8, 16, 16],
         # the same centre, sides 16: every anchor; overwrites GT 0's slots
         [4, 4, 20, 20],
         # centre (3, 3): cell (0, 0), both neighbours off the map
         [0, 0, 6, 6],
         # centre (34, 34) past the map: clipped into cell (3, 3)
         [28, 28, 40, 40],
         # padding with a real box
         [0, 0, 32, 32]],
        # GT 0's centre cell (2, 2) at half a cell; GT 1's centre (1.75,
        # 2.75) in cells: its x neighbour is that cell, and GT 1 overwrites
        # it; GT 2 pads
        [[16, 16, 24, 24],
         [10, 18, 18, 26],
         [8, 8, 24, 24],
         [0, 0, 0, 0],
         [0, 0, 0, 0]]], np.float64)
    classes = np.array([[1, 2, 3, 0, 1], [3, 1, 2, 0, 0]], np.int32)
    mask = np.array([[True, True, True, True, False],
                     [True, True, False, False, False]])
    return gt, classes, mask, np.array(ANCHORS), 8, (4, 4)


def test_yolov5_assign_matches_jax_exactly_f64():
    args = _dyadic_case()
    with jax.enable_x64(True):
        ref = _jax_assign(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args))
    gt, classes, mask, anchors, stride, hw = args
    got = tyolov5.yolov5_assign(_t(gt), _t(classes), _t(mask), _t(anchors),
                                stride, hw)
    for g, r, name in zip(got, ref, ("pos", "tbox", "tcls")):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    pos, tbox, tcls = ref
    assert got[2].dtype == torch.int32
    slot = lambda y, x, a: y * 12 + x * 3 + a  # noqa: E731
    # the half-cell centre's neighbours are right and down; GT 1 wrote last
    for y, x in ((1, 1), (1, 2), (2, 1)):
        assert [tcls[0, slot(y, x, a)] for a in range(3)] == [2, 2, 2]
        np.testing.assert_array_equal(tbox[0, slot(y, x, 0)], gt[0, 1])
    assert pos[0, slot(1, 0, 0)] == 0 and pos[0, slot(0, 1, 0)] == 0
    # GT 2 at cell (0, 0) only, anchors 0 and 1 (its ratio to 32 is 5.3)
    assert [pos[0, slot(0, 0, a)] for a in range(3)] == [1, 1, 0]
    # GT 3 clipped into cell (3, 3), its neighbours off the map
    assert tcls[0, slot(3, 3, 1)] == 0 and pos[0, slot(3, 3, 1)] == 1
    assert pos[0].sum() == 9 + 2 + 3
    # image 1: GT 1's neighbour (2, 2) is GT 0's centre: GT 1 wins there
    assert tcls[1, slot(2, 2, 0)] == 1
    np.testing.assert_array_equal(tbox[1, slot(2, 2, 0)], gt[1, 1])
    assert (tbox[pos == 0] == 0).all() and (tcls[pos == 0] == 0).all()


@pytest.mark.parametrize("level", [0, 1, 2])
def test_yolov5_assign_matches_jax_at_full_size(level):
    """The reference generator's boxes at 640 x 640 (16 slots, 80 classes,
    f32) on each level of YOLOv5-s (``YOLOV5_ANCHORS``): the maps equal."""
    b = synthetic_detection_batch(4, (640, 640), 80, seed=11)
    stride = tyolov5.AnchorYOLO.STRIDES[level]
    hw = (640 // stride, 640 // stride)
    anchors = np.asarray(tyolov5.YOLOV5_ANCHORS[level], np.float32)
    ref = _jax_assign(jnp.asarray(b["gt_boxes"]), jnp.asarray(b["gt_classes"]),
                      jnp.asarray(b["gt_mask"]), jnp.asarray(anchors),
                      stride, hw)
    got = tyolov5.yolov5_assign(_t(b["gt_boxes"]), _t(b["gt_classes"]),
                                _t(b["gt_mask"]), _t(anchors), stride, hw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert ref[0].sum() > 0


@pytest.fixture(scope="module")
def f64():
    variables = random_variables(_tiny_shapes(), seed=8)
    return step_both(jyolov5.YOLOv5(**TINY, dtype=jnp.float64),
                     tyolov5.YOLOv5(**TINY, dtype=torch.float64),
                     yolov5_from_flax, variables, _step_batch(),
                     YOLOV5_MOMENTUM)


def test_loss_parts_match_jax_f64(f64):
    check_loss_parts(f64, PARTS)


def test_train_step_matches_jax_f64(f64):
    check_train_step(f64, tyolov5.YOLOv5(**TINY), yolov5_from_flax)


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov5_train_entry()


def test_train_entry_builds_on_cpu_when_asked():
    """``yolov5_train_entry`` builds (no step): f32 parameters, bf16
    compute, train mode; guarded Nesterov SGD 0.937 with decay 5e-4 on
    ndim > 1 parameters, no clip, lr 0 at count 0 of the config's warm-up
    cosine (22000 steps of warm-up); the reference's batch."""
    step_fn, (state, batch) = yolov5_train_entry(device="cpu", batch=2)
    model, tx = state.model, state.tx
    assert callable(step_fn) and model.training
    assert model.dtype == torch.bfloat16 and model.image_hw == (640, 640)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (tx.momentum, tx.nesterov, tx.weight_decay, tx.clip_global_norm,
            tx.nan_guard) == (0.937, True, 5e-4, None, True)
    assert float(tx.learning_rate(torch.tensor(0))) == 0.0
    assert float(tx.learning_rate(torch.tensor(YOLOV5_WARMUP))) == \
        pytest.approx(YOLO_LR)
    assert float(tx.learning_rate(torch.tensor(YOLOV5_WARMUP // 2))) == \
        pytest.approx(YOLO_LR / 2)
    want = synthetic_detection_batch(2, (640, 640), 80)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
