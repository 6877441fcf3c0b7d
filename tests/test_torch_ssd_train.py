"""The port's SSD train path vs the JAX package's, on the CPU.

- The targets and the mining, exactly in f64 at 64 x 64 (144 anchors): the
  reference's loss runs on given class logits and box deltas (a test
  subclass whose ``__call__`` returns them) with ``jax.vmap`` recorded, so
  that its one-image ``per_image`` reports the labels, class targets and
  box targets it made; its kept negatives are the negatives whose logits
  get a gradient from its loss (a kept anchor's cross entropy has a
  gradient on every logit, a dropped one none). The GT boxes are dyadic:
  one at IoU exactly 0.5 with an anchor (positive), one whose two best
  anchors tie (both forced positive), a masked one over anchors; the
  logits put a group of negatives at one tied cross entropy straddling
  the 3 x n_pos cut (the lower anchors kept).
- ``loss_from_outputs`` on random outputs in f64: the loss and its parts
  1e-12, the gradients to the outputs 1e-10 of their largest.
- One train step of SSD (4 classes, 96 x 96, batch 2, a GT over most of
  each image among the others, so that every map has a positive) with f64
  compute over f32 parameters and the config's SGD (momentum 0.9 without
  Nesterov, decay 4e-5) at a constant lr 0.01: the loss parts 1e-6, every
  gradient 1e-5 of its largest element, the parameters after the step and
  the BN statistics 1e-6 (``test_torch_yolox_train.py``'s checks); the
  gradients that cancel (BN biases seen only through a linear layer and a
  train-mode BN) under 1e-10 of the largest gradient on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov3_train import record_vmaps
from test_torch_yolox_train import (check_loss_parts, check_train_step,
                                    step_both)

from minddet_tpu.models.detectors import ssd as jssd
from minddet_tpu_torch import entry
from minddet_tpu_torch.models.detectors import ssd as tssd
from minddet_tpu_torch.ops.box import pairwise_iou
from minddet_tpu_torch.utils.convert import ssd_from_flax

PARTS = ("cls_loss", "reg_loss")
SMALL = dict(num_classes=4, image_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


class _GivenOutputs(jssd.SSD):
    """The reference's SSD whose forward returns the (class logits, box
    deltas) passed as the image: its ``loss`` on given outputs."""

    def __call__(self, image, train=False):
        return image


def _dyadic_case():
    """Two images at 64 x 64, 4 GT slots. The maps of 1 cell put their
    anchors at the centre (32, 32): level 2's first (ratio 1) is [16, 16,
    48, 48]; its ratio-2 and ratio-1/2 anchors are each other's
    transposes."""
    gt = np.array([
        [[16, 16, 32, 48],   # IoU exactly 0.5 with [16, 16, 48, 48]
         [28, 28, 36, 36],   # a square at the centre: two tied best anchors
         [0, 0, 24, 24],
         [16, 16, 48, 48]],  # masked, over anchors
        [[40, 8, 60, 30], [2, 34, 22, 62], [0, 0, 0, 0], [0, 0, 0, 0]]],
        np.float64)
    classes = np.array([[1, 3, 2, 0], [0, 2, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    return dict(gt_boxes=gt, gt_classes=classes, gt_mask=mask)


def _outputs(rs, anchors, tied=None, ahead=None):
    """Random class logits (2, A, 5) with the background's far higher and
    random deltas; ``tied`` anchors get one row of logits with the
    background's low (one cross entropy, ~3.9, over every random row's),
    ``ahead`` anchors one with it lower still (~7.4)."""
    a = anchors.shape[0]
    cls = rs.randn(2, a, 5)
    cls[..., 0] += 6.0
    if tied is not None:
        cls[:, tied] = [-2.0, 0.5, 0.25, -0.5, 1.0]
        cls[:, ahead] = [-6.0, 1.0, 1.0, 1.0, 1.0]
    return cls, rs.randn(2, a, 4) * 0.5


def _reference(outs, gt, monkeypatch):
    """The reference's loss on ``outs`` in f64: per image (labels, class
    target, box target) from ``per_image`` (recorded, eagerly: jitted, XLA
    divides by the constant stds as a product with their reciprocals), the
    loss and its parts, and the gradients of the loss to the logits and
    deltas (jitted)."""
    jm = _GivenOutputs(**SMALL)
    with jax.enable_x64(True):
        jgt = {k: jnp.asarray(v) for k, v in gt.items()}

        def loss(o):
            return jm.apply({}, dict(image=o, **jgt), method=jm.loss)

        o = tuple(jnp.asarray(x) for x in outs)
        calls = record_vmaps(jssd, monkeypatch, loss, o, jit=False)
        (total, parts), grads = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(o))
    ((_, _, targets),) = [c for c in calls if c[0] == "per_image"]
    return targets, total, parts, grads


def test_targets_and_mining_match_jax_exactly_f64(monkeypatch):
    gt = _dyadic_case()
    tm = tssd.SSD(**SMALL)
    (anchors,) = tm.anchor_boxes("cpu")
    labels_0, _, _ = tssd.ssd_targets(anchors, _t(gt["gt_boxes"]),
                                      _t(gt["gt_classes"]),
                                      _t(gt["gt_mask"]))
    # ten negatives of image 0 at one CE straddle the cut (3 x its n_pos):
    # 3 n_pos - 4 later negatives rank ahead of them
    n_pos = int((labels_0[0] == 1).sum())
    negatives = (labels_0[0] == 0).nonzero()[:, 0].numpy()
    tied = negatives[10:20]
    ahead = negatives[-(3 * n_pos - 4):]
    outs = _outputs(np.random.RandomState(0), anchors, tied, ahead)
    (labels, cls_t, reg_t), _, _, grads = _reference(outs, gt, monkeypatch)
    got = tssd.ssd_targets(anchors, _t(gt["gt_boxes"]), _t(gt["gt_classes"]),
                           _t(gt["gt_mask"]))
    for g, r, name in zip(got, (labels, cls_t, reg_t),
                          ("labels", "cls_t", "reg_t")):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    cls, _ = (_t(o) for o in outs)
    pos = (got[0] == 1).float()
    logp = torch.log_softmax(cls.float(), -1)
    ce = -torch.gather(logp, -1, got[1][..., None])[..., 0]
    keep = tssd.hard_negatives(ce, got[0], pos.sum(1, keepdim=True))
    want = (np.abs(grads[0]) > 0).any(-1) & (labels == 0)
    np.testing.assert_array_equal(keep.numpy(), want)
    # the case covers what it says it does
    iou = pairwise_iou(anchors.double(), _t(gt["gt_boxes"][0])).numpy()
    exact = iou[:, 0] == 0.5
    assert exact.any() and (labels[0][exact] == 1).all()
    best = iou[:, 1] == iou[:, 1].max()
    assert best.sum() == 2 and iou[:, 1].max() < 0.5
    assert (labels[0][best] == 1).all()
    assert (iou[:, 3] > 0.5).any() and not mask_used(labels, iou)
    assert keep[0, tied].tolist() == [True] * 4 + [False] * 6
    assert int(keep[0].sum()) == 3 * n_pos
    assert int(keep[1].sum()) == 3 * int((labels[1] == 1).sum())


def mask_used(labels, iou):
    """Whether an anchor is positive only through the masked GT 3 of image
    0 (IoU >= 0.5 with it, under 0.5 with every valid GT, not a valid GT's
    best)."""
    valid = iou[:, :3]
    forced = (valid == valid.max(0, keepdims=True)).any(1)
    only = (iou[:, 3] >= 0.5) & (valid.max(1) < 0.5) & ~forced
    return bool((labels[0][only] == 1).any())


def test_loss_on_given_outputs_matches_jax_f64(monkeypatch):
    """Random logits and deltas (f64): the loss and its parts within 1e-12,
    the gradients to both within 1e-10 of their largest."""
    gt = _dyadic_case()
    (anchors,) = tssd.SSD(**SMALL).anchor_boxes("cpu")
    outs = _outputs(np.random.RandomState(1), anchors)
    _, total, parts, grads = _reference(outs, gt, monkeypatch)
    tm = tssd.SSD(**SMALL)
    touts = [_t(o).requires_grad_(True) for o in outs]
    got, got_parts = tm.loss_from_outputs(
        *touts, {k: _t(v) for k, v in gt.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-12)
    for k in PARTS:
        np.testing.assert_allclose(got_parts[k].item(), float(parts[k]),
                                   rtol=1e-12, err_msg=k)
    for t, r in zip(touts, grads):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())


TRAIN = dict(num_classes=4, image_size=96)


def _train_batch():
    rs = np.random.RandomState(4)
    gt = np.array([[[4, 6, 50, 60], [40, 44, 90, 92], [60, 10, 80, 34],
                    [0, 0, 0, 0], [2, 2, 94, 94]],
                   [[10, 20, 70, 64], [8, 60, 30, 90], [0, 0, 0, 0],
                    [50, 50, 90, 90], [6, 0, 84, 96]]], np.float32)
    return dict(image=rs.rand(2, 96, 96, 3).astype(np.float32), gt_boxes=gt,
                gt_classes=np.array([[1, 3, 0, 0, 2], [2, 0, 0, 1, 3]],
                                    np.int32),
                gt_mask=np.array([[1, 1, 1, 0, 1], [1, 1, 0, 0, 1]], bool))


@pytest.fixture(scope="module")
def f64():
    jm = jssd.SSD(**TRAIN)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 96, 96, 3))))
    variables = random_variables({k: dict(v) for k, v in shapes.items()}, 12)
    return step_both(jssd.SSD(**TRAIN, dtype=jnp.float64),
                     tssd.SSD(**TRAIN, dtype=torch.float64), ssd_from_flax,
                     variables, _train_batch(), entry.SSD_MOMENTUM,
                     nesterov=False, weight_decay=entry.SSD_WEIGHT_DECAY)


def test_loss_parts_match_jax_f64(f64):
    check_loss_parts(f64, PARTS)


def test_train_step_matches_jax_f64(f64):
    """As ``check_train_step`` holds the YOLOs, and the BN biases whose
    gradient cancels (an ``InvertedResidual``'s ``project_bn`` that feeds
    only the next block's 1x1 expand and its train-mode BN): under 1e-10
    of the largest gradient on both sides. A large GT in each image
    reaches the last maps, so every extra block and multibox head gets a
    gradient."""
    check_train_step(f64, tssd.SSD(**TRAIN), ssd_from_flax, cancelled=1e-10)
    reached = [n for n, p in f64["state"].model.named_parameters()
               if n.startswith(("extra", "multibox")) and bool(p.grad.any())]
    assert len(reached) == 4 * 6 + 6 * 4, reached
