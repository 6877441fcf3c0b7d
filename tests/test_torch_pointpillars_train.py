"""The port's PointPillars train path vs the JAX package's, on the CPU.

- ``distance_similarity`` at 1e-6.
- ``assign_targets_batch`` (the reference's ``assign_targets`` under
  ``vmap``): exactly in f64 on anchors and boxes of
  dyadic coordinates (padded ground truth, a masked anchor, a ground-truth
  box whose best IoU four anchors tie below the matched threshold, the
  ignore band, a box that overlaps nothing), and in f32 on the tiny model's
  anchors, where a label may differ only for an anchor whose IoU lies
  within ``NEAR_THRESHOLD`` of a threshold or of a box's best (XLA's CPU
  compile contracts multiply-adds into FMAs).
- The loss helpers and the three losses at 1e-6.
- ``loss_from_gt`` and one train step (AdamW 2e-4, no clip) on the tiny
  model of ``test_torch_pointpillars.py`` (grid 32x32, RPN (1, 1, 1)),
  weights through ``pointpillars_from_flax``: with f64 compute over f32
  parameters (the assignment on f64 boxes, the losses in f32 as the
  reference computes them) the loss parts 1e-6, every gradient 1e-5 of its
  largest element, the parameters and BN statistics after the step 1e-6;
  with f32 compute the parts rtol 1e-4 and the BN statistics 1e-5.
- The 7-wide synthetic batch against ``synthetic_points_batches``, and the
  train entry.

The ground-truth boxes are car-sized and jittered off the anchor grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import PCR, TINY, random_variables

from minddet_tpu.core.optim import adamw as jax_adamw
from minddet_tpu.models import losses as jlosses
from minddet_tpu.models.detectors import pointpillars as jpp
from minddet_tpu.ops import anchors as janchors
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu.train.train import synthetic_points_batches
from minddet_tpu_torch.core.optim import adamw
from minddet_tpu_torch.entry import (CLOUD_POINTS, PP_TRAIN_LR,
                                     model_gt_loss, pointpillars_train_entry,
                                     synthetic_clouds, synthetic_lidar_batch)
from minddet_tpu_torch.models import losses as tlosses
from minddet_tpu_torch.models.detectors import pointpillars as tpp
from minddet_tpu_torch.ops import anchors as tanchors
from minddet_tpu_torch.ops.box import pairwise_iou, rbbox_to_near_bbox
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.utils.convert import (adamw_state_from_optax,
                                             pointpillars_from_flax)

NEAR_THRESHOLD = 1e-6
GT_SLOTS = 8
PARTS = ("loc_loss", "cls_loss", "dir_loss")
BEV = [0, 1, 3, 4, 6]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's tensors are small: one intra-op thread is faster
    for them than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit_assign(*args):
    return jax.device_get(jax.jit(janchors.assign_targets_batch)(*args))


def _dyadic_case():
    """Anchors (2 x 4 m, yaw 0 and pi/2) on a 0.5 m grid and two samples of
    ground truth whose coordinates are all dyadic, so that every IoU is
    exact in f64: sample 0 has a box 1/8 m off an anchor (positives and the
    ignore band; its best anchor is masked), a 1 x 2 m box that several
    anchors cover wholly (its best IoU, 0.25, tied below the unmatched
    threshold: forced positives), a box 100 m away (best IoU 0: never
    forced) and two padded slots that hold real-looking boxes; sample 1 a
    rotated box and padding."""
    xs, ys = np.meshgrid(np.arange(16) * 0.5, np.arange(8) * 0.5,
                         indexing="xy")
    cells = np.stack([xs.ravel(), ys.ravel()], -1)
    anchors = np.concatenate([
        np.concatenate([cells, np.zeros((len(cells), 1)),
                        np.tile([2.0, 4.0, 2.0], (len(cells), 1)),
                        np.full((len(cells), 1), yaw)], -1)
        for yaw in (0.0, np.pi / 2)])
    gt = np.zeros((2, 6, 7))
    gt[0, 0] = [2.125, 1.0, 0.25, 2.0, 4.0, 2.0, 0.0]
    gt[0, 1] = [5.25, 2.0, 0.0, 1.0, 2.0, 1.5, 0.0]
    gt[0, 2] = [100.0, 100.0, 0.0, 2.0, 4.0, 2.0, 0.0]
    gt[0, 3] = [7.0, 3.0, 0.0, 2.0, 4.0, 2.0, 0.0]   # padding
    gt[0, 4] = [0.5, 0.5, 0.0, 2.0, 4.0, 2.0, 0.0]   # padding
    gt[1, 0] = [3.0625, 1.5, 0.5, 2.25, 3.75, 2.0, 1.25]
    gt[1, 1] = [6.0, 2.0, 0.0, 2.0, 4.0, 2.0, 0.0]   # padding
    mask = np.zeros((2, 6), bool)
    mask[0, :3] = True
    mask[1, 0] = True
    classes = np.array([[1, 2, 1, 2, 1, 1], [2, 1, 1, 1, 1, 1]], np.int32)
    amask = np.ones((2, len(anchors)), bool)
    best0 = int(np.flatnonzero((anchors[:, :2] == [2.0, 1.0]).all(1)
                               & (anchors[:, 6] == 0.0))[0])
    amask[0, best0] = False
    m_th = np.full(len(anchors), 0.6)
    u_th = np.full(len(anchors), 0.45)
    return anchors, gt, classes, mask, m_th, u_th, amask, best0


def test_assign_targets_batch_matches_jax_exactly_f64():
    anchors, gt, classes, mask, m_th, u_th, amask, best0 = _dyadic_case()
    with jax.enable_x64(True):
        ref = _jit_assign(*(jnp.asarray(a) for a in (
            anchors, gt, classes, mask, m_th, u_th, amask)))
    got = tanchors.assign_targets_batch(*(torch.from_numpy(a) for a in (
        anchors, gt, classes, mask, m_th, u_th, amask)))
    labels = got["labels"].numpy()
    assert got["labels"].dtype == torch.int32
    np.testing.assert_array_equal(labels, ref["labels"])
    np.testing.assert_array_equal(got["bbox_targets"].numpy(),
                                  ref["bbox_targets"])
    np.testing.assert_array_equal(got["reg_weights"].numpy(),
                                  ref["reg_weights"])
    # the case covers what it says it does
    iou = pairwise_iou(rbbox_to_near_bbox(torch.from_numpy(anchors[:, BEV])),
                       rbbox_to_near_bbox(torch.from_numpy(gt[0][:, BEV])))
    assert labels[0, best0] == -1 and float(iou[best0, 0]) > 0.6
    tie = (iou[:, 1] == 0.25).numpy() & amask[0]
    assert tie.sum() >= 4 and (labels[0][tie] == 2).all()
    band = ((iou[:, 0] >= 0.45) & (iou[:, 0] < 0.6)).numpy()
    assert band.any() and (labels[0][band] == -1).all()
    assert ((labels[0] == 1).sum() >= 2 and (labels[0] == 0).sum() > 100
            and (labels[1] > 0).any())
    # the padded slots' boxes are nowhere assigned
    padded = (iou[:, 3] > 0.45) | (iou[:, 4] > 0.45)
    assert padded.any() and (labels[0][padded.numpy()] == 0).all()


@pytest.mark.parametrize("norm,batched", [(2.0, False), (3.0, False),
                                          (2.0, True)])
def test_distance_similarity_matches_jax(norm, batched):
    """(N, 5) x (M, 5) against the reference at its default norm and
    another; batched (B, N, 5) x (B, M, 5) against it under ``vmap``."""
    rs = np.random.RandomState(3)
    b1 = rs.uniform(-5, 5, (2, 30, 5)).astype(np.float32)
    b2 = rs.uniform(-5, 5, (2, 20, 5)).astype(np.float32)
    if not batched:
        b1, b2 = b1[0], b2[0]
    def fn(x, y):
        return janchors.distance_similarity(x, y, norm)

    ref = np.asarray((jax.vmap(fn) if batched else fn)(jnp.asarray(b1),
                                                       jnp.asarray(b2)))
    got = tanchors.distance_similarity(torch.from_numpy(b1),
                                       torch.from_numpy(b2), norm)
    assert got.shape == b1.shape[:-2] + (30, 20)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def _tiny_anchor_set():
    gen = jpp.PointPillars(**TINY).anchor_set()
    return {k: np.array(v) for k, v in gen.items()}


def _gt_boxes(b, rs, slots=GT_SLOTS, real=5):
    """Per cloud ``real`` car-sized boxes [x, y, z, w, l, h, yaw] over the
    tiny range, centres and sizes jittered off the anchor grid, yaws near 0
    and pi/2 or anywhere, in ``slots`` slots; the padded slots hold boxes
    too (the mask must hide them)."""
    gt = np.zeros((b, slots, 7), np.float32)
    gt[..., 0] = rs.uniform(1.0, 5.4, (b, slots))
    gt[..., 1] = rs.uniform(-2.2, 2.2, (b, slots))
    gt[..., 2] = -1.8 + rs.uniform(-0.2, 0.2, (b, slots))
    gt[..., 3:6] = [1.6, 3.9, 1.56] * rs.uniform(0.9, 1.1, (b, slots, 3))
    axis = rs.randint(0, 2, (b, slots)) * np.pi / 2
    gt[..., 6] = np.where(rs.rand(b, slots) < 0.7,
                          axis + rs.uniform(-0.2, 0.2, (b, slots)),
                          rs.uniform(-np.pi, np.pi, (b, slots)))
    mask = np.zeros((b, slots), bool)
    mask[:, :real] = True
    return gt, mask


def test_assign_targets_batch_f32_differs_only_at_thresholds():
    """f32 on the tiny model's 512 anchors and 200 random boxes per
    sample: labels equal but where the IoU (in f64) lies within
    NEAR_THRESHOLD of 0.6, 0.45 or a box's best; targets 1e-6 where both
    label an anchor foreground."""
    gen = _tiny_anchor_set()
    rs = np.random.RandomState(7)
    gt, mask = _gt_boxes(4, rs, slots=60, real=50)
    amask = rs.rand(4, len(gen["anchors"])) < 0.9
    classes = np.ones((4, 60), np.int32)
    args = (gen["anchors"], gt, classes, mask, gen["matched_threshold"],
            gen["unmatched_threshold"], amask)
    ref = _jit_assign(*(jnp.asarray(a) for a in args))
    got = tanchors.assign_targets_batch(*(torch.from_numpy(a)
                                          for a in args))
    iou = pairwise_iou(
        rbbox_to_near_bbox(torch.from_numpy(gen["anchors"][:, BEV]).double()),
        rbbox_to_near_bbox(torch.from_numpy(gt[..., BEV]).double()))
    iou = torch.where(torch.from_numpy(mask)[:, None], iou, -1.0)
    best = iou.amax(1, keepdim=True)
    near = ((iou - 0.6).abs() < NEAR_THRESHOLD) | (
        (iou - 0.45).abs() < NEAR_THRESHOLD) | (
        ((iou - best).abs() < NEAR_THRESHOLD) & (iou > 0))
    near = near.any(-1).numpy()
    differ = got["labels"].numpy() != ref["labels"]
    assert not (differ & ~near).any()
    assert differ.sum() <= 2, int(differ.sum())
    fg = (got["labels"].numpy() > 0) & (ref["labels"] > 0)
    assert fg.sum() > 50 and (ref["labels"] == -1).sum() > 50
    np.testing.assert_allclose(got["bbox_targets"].numpy()[fg],
                               ref["bbox_targets"][fg], rtol=0, atol=1e-6)


def test_loss_helpers_match_jax():
    rs = np.random.RandomState(11)
    labels = rs.randint(-1, 3, (3, 40)).astype(np.int32)
    labels[2] = rs.randint(-1, 1, 40)  # a sample with no positive
    ref = jpp.prepare_loss_weights(jnp.asarray(labels))
    got = tpp.prepare_loss_weights(torch.from_numpy(labels))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    p = rs.randn(3, 40, 7).astype(np.float32)
    t = rs.randn(3, 40, 7).astype(np.float32)
    for r, g in zip(jpp.add_sin_difference(jnp.asarray(p), jnp.asarray(t)),
                    tpp.add_sin_difference(torch.from_numpy(p),
                                           torch.from_numpy(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    anchors = rs.uniform(-3, 3, (40, 7)).astype(np.float32)
    ref = jpp.get_direction_target(jnp.asarray(anchors), jnp.asarray(t))
    got = tpp.get_direction_target(torch.from_numpy(anchors),
                                   torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("alpha", [0.25, 0.75])
def test_losses_match_jax(alpha):
    rs = np.random.RandomState(12)
    logits = (rs.randn(2, 50, 3) * 4).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 50))][..., 1:]
    w = rs.uniform(0, 1, (2, 50)).astype(np.float32)
    tl, tw = torch.from_numpy(logits), torch.from_numpy(w)
    np.testing.assert_allclose(
        tlosses.optax_sigmoid_ce(tl, torch.from_numpy(onehot)).numpy(),
        np.asarray(jlosses.optax_sigmoid_ce(jnp.asarray(logits),
                                            jnp.asarray(onehot))),
        rtol=1e-6, atol=1e-6)
    for weights in (w, w[..., None] * np.ones(3, np.float32), None):
        ref = jlosses.sigmoid_focal_loss(
            jnp.asarray(logits), jnp.asarray(onehot),
            None if weights is None else jnp.asarray(weights), 2.0, alpha)
        got = tlosses.sigmoid_focal_loss(
            tl, torch.from_numpy(onehot),
            None if weights is None else torch.from_numpy(weights), 2.0,
            alpha)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    # smooth L1 on both sides of its kink at 1 / sigma^2
    pred = rs.uniform(-0.3, 0.3, (2, 50, 7)).astype(np.float32)
    tgt = rs.uniform(-0.3, 0.3, (2, 50, 7)).astype(np.float32)
    ref = jlosses.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(tgt),
                                     jnp.asarray(w), 3.0)
    got = tlosses.weighted_smooth_l1(torch.from_numpy(pred),
                                     torch.from_numpy(tgt), tw, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    d = np.abs(pred - tgt)
    assert (d < 1 / 9).any() and (d > 1 / 9).any()
    dir_logits = rs.randn(2, 50, 2).astype(np.float32)
    dir_t = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (2, 50))]
    np.testing.assert_allclose(
        tlosses.weighted_softmax_ce(torch.from_numpy(dir_logits),
                                    torch.from_numpy(dir_t), tw).numpy(),
        np.asarray(jlosses.weighted_softmax_ce(
            jnp.asarray(dir_logits), jnp.asarray(dir_t), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


def _setup(compute):
    """The tiny model on both sides with ``compute`` as the compute dtype
    over f32 parameters, the ground truth and anchors in ``compute``: one
    train step each (the JAX one jitted), and the port's assignment against
    the reference's on the port's anchor mask."""
    pts, mask = synthetic_clouds(2, PCR, num_points=600, seed=1)
    gt, gt_mask = _gt_boxes(2, np.random.RandomState(5))
    batch = {"points": pts, "points_mask": mask,
             "gt_boxes": gt.astype(compute), "gt_mask": gt_mask,
             "gt_classes": np.ones((2, GT_SLOTS), np.int32)}
    batch.update({k: v.astype(compute) for k, v in _tiny_anchor_set().items()})
    with jax.enable_x64(compute == "float64"):
        jm = jpp.PointPillars(**TINY, dtype=jnp.dtype(compute))
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
            method=jm.predict_from_points))
        variables = random_variables(
            {"params": dict(shapes["params"]),
             "batch_stats": dict(shapes["batch_stats"])}, seed=2)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_apply(v, b, train=True):
            return jm.apply(v, b, train=train, method=jm.loss_from_gt,
                            mutable=["batch_stats"])

        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"],
                                      jax_adamw(PP_TRAIN_LR))
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(jstate, jbatch))

    model = pointpillars_from_flax(
        tpp.PointPillars(**TINY, dtype=getattr(torch, compute)), variables)
    model = model.to(memory_format=torch.channels_last)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the anchor mask of this batch (an eval-mode forward moves no
    # statistic), for the assignment on both sides below
    with torch.no_grad():
        _, occ = model.eval().canvas_from_points(tbatch["points"],
                                                 tbatch["points_mask"])
        amask = model.area_mask(occ)
    state = TrainState.create(model, adamw(PP_TRAIN_LR))
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model_gt_loss)(state, tbatch)
    args = (batch["anchors"], batch["gt_boxes"], batch["gt_classes"],
            batch["gt_mask"], batch["matched_threshold"],
            batch["unmatched_threshold"], amask.numpy())
    with jax.enable_x64(compute == "float64"):
        ref_t = _jit_assign(*(jnp.asarray(a) for a in args))
    got_t = tanchors.assign_targets_batch(*(torch.from_numpy(np.asarray(a))
                                            for a in args))
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, state=state,
                metrics=metrics, old=old, ref_t=ref_t, got_t=got_t,
                amask=amask)


@pytest.fixture(scope="module")
def f64():
    return _setup("float64")


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def test_loss_from_gt_targets_are_the_references_f64(f64):
    got, ref = f64["got_t"], f64["ref_t"]
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_array_equal(got["bbox_targets"].numpy(),
                                  ref["bbox_targets"])
    labels = ref["labels"]
    assert (labels > 0).sum(1).min() >= 5 and (labels == -1).sum() > 20
    assert 0 < float(f64["amask"].float().mean()) < 1


def test_loss_from_gt_parts_match_jax_f64(f64):
    metrics, jmetrics = f64["metrics"], f64["jmetrics"]
    assert set(metrics) == set(jmetrics) == {"loss", "grad_norm", *PARTS}
    for name in ("loss",) + PARTS:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-6)
    assert all(float(jmetrics[k]) > 1e-3 for k in PARTS)


def test_loss_from_gt_parts_match_jax_f32(f32):
    """f32 compute: rtol 1e-4 (a dozen f32 conv layers summed in another
    order than XLA's; the losses are f32 on both sides)."""
    metrics, jmetrics = f32["metrics"], f32["jmetrics"]
    for name in ("loss", "grad_norm") + PARTS:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-4,
                                   err_msg=name)
    differ = f32["got_t"]["labels"].numpy() != f32["ref_t"]["labels"]
    assert not differ.any()


def _reference_state(s):
    """The JAX state after its step, carried into a fresh port model."""
    new = s["new_jstate"]
    return pointpillars_from_flax(
        tpp.PointPillars(**TINY), {"params": new.params,
                                   "batch_stats": new.batch_stats})


def test_train_step_matches_jax_f64(f64):
    """One AdamW step with f64 compute: every gradient within 1e-5 of its
    largest element (the reference's is its first Adam moment over 1 - b1);
    the parameters after the step within 1e-6 where that gradient resolves
    the element (|g| above 1e-5 of the largest and 100 times Adam's eps:
    Adam's first step is ~lr * g / (|g| + eps), so an element whose
    gradient is rounding noise moves by up to +-lr on either side), the BN
    running statistics within 1e-6. Every parameter gets a gradient and
    moves."""
    model, ref = f64["state"].model, _reference_state(f64)
    mu = _first_moments(ref, f64["new_jstate"])
    got = dict(model.named_parameters())
    unresolved = 0
    for name, r in ref.named_parameters():
        p = got[name]
        assert p.grad is not None and p.grad.abs().max() > 0, name
        g_ref = mu[name] / (1 - 0.9)
        scale = float(g_ref.abs().max())
        err = float((p.grad - g_ref).abs().max())
        assert err <= 1e-5 * scale, (name, err)
        assert (r.detach() - f64["old"][name]).abs().max() > 1e-5, name
        clear = (g_ref.abs() > 1e-5 * scale) & (g_ref.abs() > 1e-6)
        unresolved += int((~clear).sum())
        np.testing.assert_allclose(p.detach()[clear].numpy(),
                                   r.detach()[clear].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert unresolved < 2e-2 * sum(p.numel() for p in got.values())
    bufs = dict(model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


def _first_moments(ref, jstate):
    """The reference's first Adam moments by the port's parameter names
    (``adamw_state_from_optax`` into ``ref``'s optimizer)."""
    opt = adamw(PP_TRAIN_LR).init(ref)
    adamw_state_from_optax(ref, opt, jstate.opt_state)
    return {n: opt.state[p]["exp_avg"] for n, p in ref.named_parameters()}


def test_train_step_statistics_match_jax_f32(f32):
    ref = _reference_state(f32)
    bufs = dict(f32["state"].model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_synthetic_batch_is_the_references_7_wide():
    pcr = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    ref = next(synthetic_points_batches(3, pcr, num_points=500, max_gt=24))
    got = synthetic_lidar_batch(3, pcr, 500, 24, num_classes=1,
                                num_features=4, box_dim=7)
    assert got["gt_boxes"].shape == (3, 24, 7)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pointpillars_train_entry()


def test_train_entry_builds_on_cpu_when_asked():
    """``pointpillars_train_entry`` builds (no step: the full-width model at
    batch 32 is for the card): f32 parameters, bf16 compute, train mode,
    AdamW 2e-4 without clip, the reference's batch."""
    step_fn, (state, batch) = pointpillars_train_entry(device="cpu",
                                                       batch=2)
    model = state.model
    assert callable(step_fn) and model.training
    assert model.dtype == model.reader.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.anchors.shape == (107136, 7)
    assert (model.grid_ny, model.grid_nx, model.max_voxels) == (496, 432,
                                                                16000)
    assert (state.tx.learning_rate, state.tx.weight_decay,
            state.tx.clip_global_norm) == (2e-4, 0.01, None)
    assert batch["points"].shape == (2, CLOUD_POINTS, 4)
    assert batch["gt_boxes"].shape == (2, 24, 7)
    assert 1 <= int(batch["gt_mask"].sum(1).min())
    assert int(batch["gt_mask"].sum(1).max()) <= 23
    assert bool((batch["gt_classes"] == 1).all())
