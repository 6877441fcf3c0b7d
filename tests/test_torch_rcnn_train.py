"""The port's Faster R-CNN and Mask R-CNN train path vs the JAX package's,
on the CPU: the R-CNN box coder, the anchor matcher, the balanced sampler,
the RPN targets, the ROI sampler, the box and mask losses, ``sgd``, and
one whole train step of each model.

Inputs come from numpy seeds; the flax variables are drawn as in
``tests/test_torch_faster_rcnn.py`` (``random_variables``) and carried over
by ``mask_rcnn_from_flax`` / ``faster_rcnn_from_flax``. The model is the
JAX fixture's size (``tests/test_faster_rcnn.py``): depth 18, 64 x 64, 5
classes, RPN top 64 per level and 32 after its NMS, 16 ROI samples; the
batch is ``synthetic_detection_batch`` (2 to 15 boxes in 20 slots, so that
padded GT slots are appended to the proposals as zero-area candidates, and
the GT bitmaps at a quarter of the image).

The reference draws from ``jax.random`` keys; the port takes the draws as
tensors. Every comparison gives the port the reference's own draws: the
same keys split as the reference splits them (``_draws``). The whole step
gets the key of ``make_rng("sampling")``, the first call in the root scope,
as inside ``loss``.

Tolerances: the discrete stages (labels, matches, sample weights, sampled
indices, class targets, mask targets) exactly, on the same inputs; the
box coder's deltas atol = rtol = 1e-5 (f32 divisions and logs); the box
and mask losses rtol 1e-5 (f32 sums in another order). The train step runs
with f64 compute over f32 parameters on both sides (``jax.enable_x64``),
where no ReLU input, smooth-L1 difference or crop lies within rounding of
its kink, so both take the same branches; the reference's heads still
return f32 (``astype(jnp.float32)``), the port's f64, and its proposals
are given to the port (they are checked against the port's own on the same
inputs in ``tests/test_torch_faster_rcnn.py``). Losses rtol 1e-6, each
parameter's gradient within 1e-5 relative L2, BN running statistics atol
1e-6, the parameters after one SGD step (lr 0.01, momentum 0.9, weight
decay 1e-4) atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minddet_tpu.core.optim import sgd as jax_sgd
from minddet_tpu.models.detectors.faster_rcnn import FasterRCNN as JFRCNN
from minddet_tpu.models.detectors.faster_rcnn import MaskRCNN as JMRCNN
from minddet_tpu.models.heads import roi_head as jroi_head
from minddet_tpu.models.heads.rpn_head import generate_proposals as j_props
from minddet_tpu.ops import anchors2d as ja
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops import roi_align as jroi
from minddet_tpu_torch.core.optim import sgd
from minddet_tpu_torch.entry import rcnn_loss
from minddet_tpu_torch.models.detectors.faster_rcnn import (FasterRCNN,
                                                             MaskRCNN)
from minddet_tpu_torch.models.heads import roi_head as troi_head
from minddet_tpu_torch.ops import anchors2d as ta
from minddet_tpu_torch.ops import box as tbox
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import (faster_rcnn_from_flax,
                                             mask_rcnn_from_flax)
from test_torch_optim import _grads, _Heads, _reached
from test_torch_resnet_bottleneck import random_variables

TINY = dict(num_classes=5, depth=18, image_hw=(64, 64), rpn_pre_nms=64,
            rpn_post_nms=32, roi_samples=16)
SLOTS = 20
CLS_GAIN = 0.5
LR, MOMENTUM, WEIGHT_DECAY = 0.01, 0.9, 1e-4
KEY = 2
# the whole step's batch: one image (the reference's XLA scatter-adds of
# the ROIAlign backward take most of the fixture's time on the CPU)
STEP_BATCH = 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rs, shape, lo=0.0, hi=60.0, min_wh=0.0, max_wh=30.0):
    xy = rs.uniform(lo, hi, shape + (2,))
    wh = rs.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _draws(key, n, unsplit=False):
    """The uniform draws of ``sample_balanced`` on ``key`` (``r1, r2 =
    split(key)``), and with ``unsplit`` the ROI sampler's draw on the key
    itself: (2 or 3, n)."""
    r1, r2 = jax.random.split(key)
    keys = [r1, r2] + ([key] if unsplit else [])
    return np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])


# ---------------------------------------------------------------------------
# the box coder, the matcher and the samplers
# ---------------------------------------------------------------------------

def test_encode_deltas_matches_jax():
    """Random boxes and anchors, zero-area and inverted ones among both
    (their sides kept at eps: large, finite deltas), and the round trip
    through ``decode_deltas``."""
    rs = np.random.RandomState(0)
    boxes = _boxes(rs, (300,), -10, 70, 0.0, 40)
    anchors = _boxes(rs, (300,), -10, 70, 0.5, 40)
    boxes[:20, 2:] = boxes[:20, :2]          # zero-area boxes
    anchors[20:30, 2:] = anchors[20:30, :2]  # zero-area anchors
    boxes[30:35, 2:] = boxes[30:35, :2] - 3  # inverted
    for stds in ((1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)):
        got = tbox.encode_deltas(_t(boxes), _t(anchors), stds=stds)
        ref = jbox.encode_deltas(jnp.asarray(boxes), jnp.asarray(anchors),
                                 stds=stds)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    # the round trip, where decode's clamp of the size ratios at 16 does
    # not bite
    ratio = ((boxes[:, 2:] - boxes[:, :2])
             / (anchors[:, 2:] - anchors[:, :2]).clip(1e-6))
    ok = (ratio > 1 / 16).all(-1) & (ratio < 16).all(-1)
    assert ok.sum() > 200
    back = tbox.decode_deltas(tbox.encode_deltas(_t(boxes[ok]),
                                                 _t(anchors[ok])),
                              _t(anchors[ok]))
    np.testing.assert_allclose(back.numpy(), boxes[ok], rtol=1e-4,
                               atol=1e-3)


def _match_inputs(seed):
    """Anchors with duplicates (a GT's best IoU held by two anchors: a tie
    the forced match must keep), GTs with masked slots, one valid GT that
    overlaps no anchor."""
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, (200,), 0, 60, 4, 30)
    anchors[100:110] = anchors[:10]
    gt = _boxes(rs, (2, 12), 0, 50, 8, 30)
    gt[:, 0] = anchors[3]                # the tie: anchors 3 and 103
    gt[1, 1] = [500, 500, 510, 510]      # far from every anchor
    mask = np.ones((2, 12), bool)
    mask[:, 9:] = False
    mask[0, 5] = False
    return anchors, gt, mask


@pytest.mark.parametrize("force_match", [True, False])
@pytest.mark.parametrize("pos_iou, neg_iou", [(0.7, 0.3), (0.5, 0.5)])
def test_match_anchors_matches_jax(force_match, pos_iou, neg_iou):
    """Labels and matched indices exactly, per image: forced matches keep
    ties (``iou == g_best``), the argmax takes the first maximum, masked
    GTs read -1 and are matched by no anchor that a valid GT overlaps."""
    anchors, gt, mask = _match_inputs(1)
    labels, match = ta.match_anchors(_t(anchors), _t(gt), _t(mask), pos_iou,
                                     neg_iou, force_match)
    for i in range(2):
        rl, rm = ja.match_anchors(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                  jnp.asarray(mask[i]), pos_iou, neg_iou,
                                  force_match)
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(rl))
        np.testing.assert_array_equal(match[i].numpy(), np.asarray(rm))
    if force_match:
        assert labels[0, 3] == labels[0, 103] == 1  # the tie, both forced
    assert (labels == 1).any() and (labels == 0).any()
    # an ignored band only between distinct thresholds
    assert bool((labels == -1).any()) == (pos_iou > neg_iou)


@pytest.mark.parametrize("num_samples, pos_fraction, pos_share", [
    (256, 0.5, 0.05), (64, 0.25, 0.5), (16, 0.5, 0.0), (600, 0.5, 0.2)])
def test_sample_balanced_on_jax_draws(num_samples, pos_fraction, pos_share):
    """The weights exactly on the reference's draws: positives capped at
    num_samples * pos_fraction (more positives than the cap, fewer, none),
    ties of 1 + u and 2 + u rounded in f32 included, and more samples asked
    for than there are candidates."""
    rs = np.random.RandomState(2)
    a = 500
    labels = rs.choice([-1, 0, 1], size=(2, a),
                       p=[0.2, 0.8 - pos_share, pos_share]).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draws = np.stack([_draws(k, a) for k in keys])
    got = ta.sample_balanced(_t(draws[:, 0]), _t(draws[:, 1]),
                             _t(labels).long(), num_samples, pos_fraction)
    assert got.dtype == torch.float32
    for i in range(2):
        ref = ja.sample_balanced(keys[i], jnp.asarray(labels[i]),
                                 num_samples, pos_fraction)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    assert got.sum() > 0


def test_rpn_targets_on_jax_draws():
    """``rpn_targets`` on the tiny model's 1,023 anchors and a batch's GTs
    (masked slots included): labels and both weights exactly, deltas 1e-5."""
    anchors = np.asarray(ja.multilevel_anchors((64, 64), (4, 8, 16, 32, 64)))
    batch = synthetic_detection_batch(2, (64, 64), 5, slots=SLOTS)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    draws = np.stack([_draws(k, anchors.shape[0]) for k in keys])
    got = ta.rpn_targets(_t(draws[:, 0]), _t(draws[:, 1]), _t(anchors),
                         _t(batch["gt_boxes"]), _t(batch["gt_mask"]))
    for i in range(2):
        ref = ja.rpn_targets(keys[i], jnp.asarray(anchors),
                             jnp.asarray(batch["gt_boxes"][i]),
                             jnp.asarray(batch["gt_mask"][i]))
        for k in ("labels", "cls_weights", "reg_weights"):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        np.testing.assert_allclose(got["deltas"][i].numpy(),
                                   np.asarray(ref["deltas"]), rtol=1e-5,
                                   atol=1e-5)
    assert got["reg_weights"].sum() > 0


def _proposal_inputs(seed):
    """Proposals near a batch's GTs (some over 0.5 IoU), zero-area and
    zero-padded ones among them, and the batch."""
    rs = np.random.RandomState(seed)
    batch = synthetic_detection_batch(2, (64, 64), 5, seed=seed,
                                      with_masks=True, slots=SLOTS)
    props = _boxes(rs, (2, 32), 0, 50, 2, 30)
    props[:, :8] = batch["gt_boxes"][:, :8] + rs.uniform(
        -2, 2, (2, 8, 4)).astype(np.float32)
    props[:, 25:27, 2:] = props[:, 25:27, :2]  # zero-area
    props[:, 28:] = 0.0                        # padding
    return props, batch


def test_sample_proposals_on_jax_draws():
    """The ROI sampler on the reference's three draws per image: rois,
    class targets, matched GTs and both masks exactly (zero-area
    candidates, from the proposals and the padded GT slots, are sampled as
    negatives), delta targets 1e-5."""
    props, batch = _proposal_inputs(5)
    n = props.shape[1] + SLOTS
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    draws = np.stack([_draws(k, n, unsplit=True) for k in keys])
    d = _t(draws)
    got = troi_head.sample_proposals(
        d[:, 0], d[:, 1], d[:, 2], _t(props), _t(batch["gt_boxes"]),
        _t(batch["gt_classes"]), _t(batch["gt_mask"]), 16)
    for i in range(2):
        ref = jroi_head.sample_proposals(
            keys[i], jnp.asarray(props[i]), jnp.asarray(batch["gt_boxes"][i]),
            jnp.asarray(batch["gt_classes"][i]),
            jnp.asarray(batch["gt_mask"][i]), 16)
        for k in ("rois", "cls_target", "pos_mask", "valid_mask",
                  "matched_gt"):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        np.testing.assert_allclose(got["delta_target"][i].numpy(),
                                   np.asarray(ref["delta_target"]),
                                   rtol=1e-5, atol=1e-5)
    rois = got["rois"]
    zero = (rois[..., 2:] - rois[..., :2]).prod(-1) <= 0
    assert zero.any() and (got["pos_mask"] > 0).any()
    assert bool((got["cls_target"][zero] == 0).all())


def _jax_targets(seed):
    props, batch = _proposal_inputs(seed)
    n = props.shape[1] + SLOTS
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    refs = [jroi_head.sample_proposals(
        keys[i], jnp.asarray(props[i]), jnp.asarray(batch["gt_boxes"][i]),
        jnp.asarray(batch["gt_classes"][i]),
        jnp.asarray(batch["gt_mask"][i]), 16) for i in range(2)]
    jt = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *refs)
    tt = {k: _t(v) for k, v in jt.items()}
    tt["cls_target"] = tt["cls_target"].long()
    tt["matched_gt"] = tt["matched_gt"].long()
    return jt, tt, batch


def test_box_head_loss_matches_jax():
    """Cross-entropy over the valid rois and smooth L1 of each positive
    roi's own class deltas (differences on both sides of the kink at 1),
    rtol 1e-5."""
    jt, tt, _ = _jax_targets(6)
    rs = np.random.RandomState(6)
    cls = (rs.randn(2, 16, 6) * 2).astype(np.float32)
    deltas = (rs.randn(2, 16, 5, 4) * 1.5).astype(np.float32)
    got = troi_head.box_head_loss(_t(cls), _t(deltas), tt)
    ref = jroi_head.box_head_loss(jnp.asarray(cls), jnp.asarray(deltas), jt)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
    assert float(ref[1]) > 0


def test_mask_head_loss_matches_jax():
    """The mask targets (the GT bitmaps cropped at 28 x 28, sampling 2, on
    the rois over stride 4, the matched channel, > 0.5) exactly against the
    reference's crop, and the loss rtol 1e-5."""
    jt, tt, batch = _jax_targets(7)
    rs = np.random.RandomState(7)
    logits = (rs.randn(2, 16, 28, 28, 5) * 2).astype(np.float32)
    bitmaps = batch["gt_bitmaps"]
    got = troi_head.mask_head_loss(_t(logits), _t(bitmaps), tt, stride=4)
    ref = jroi_head.mask_head_loss(jnp.asarray(logits), jnp.asarray(bitmaps),
                                   jt, stride=4)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    crops = np.asarray(jroi.roi_align(jnp.asarray(bitmaps), jt["rois"] / 4.0,
                                      (28, 28), 2))
    want = np.take_along_axis(
        crops, np.asarray(jt["matched_gt"])[:, :, None, None, None],
        axis=-1)[..., 0] > 0.5
    targets = troi_head.mask_targets(_t(bitmaps), tt, stride=4)
    np.testing.assert_array_equal(targets.numpy(), want.astype(np.float32))
    assert 0 < want.mean() < 1


# ---------------------------------------------------------------------------
# sgd
# ---------------------------------------------------------------------------

def _run_sgd(params, grads, clip):
    """3 steps of the reference's ``sgd`` chain and of the port's recipe;
    returns the parameters after each."""
    tx = jax_sgd(LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                 clip_global_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    model = _Heads(params)
    recipe = sgd(LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                 clip_global_norm=clip)
    opt = recipe.init(model)
    out = []
    for step, g in enumerate(grads):
        reached = _reached(step)
        jg = {k: jnp.asarray(v if k in reached else np.zeros_like(v))
              for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad(set_to_none=True)
        for name in reached:
            getattr(model, name).grad = torch.tensor(g[name])
        norm = recipe.update(opt, model.parameters())
        want_norm = np.sqrt(sum(float(np.sum(g[k] ** 2)) for k in reached))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        out.append(({k: np.asarray(v) for k, v in jparams.items()},
                    {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()}))
    return out


@pytest.mark.parametrize("clip", [None, 35.0])
@pytest.mark.parametrize("name", ["used", "late", "unused", "bias"])
def test_sgd_unreached_parameters_match_optax(name, clip):
    """Each parameter after each of 3 steps of the R-CNN config's SGD (lr
    0.01, momentum 0.9, weight decay 1e-4 on ndim > 1), without and with a
    clip of 35 (step 2's gradients have a norm of ~200): |port - optax| <=
    1e-6 + 1e-6 * |optax|. ``unused`` (2-D) is only decayed, and its trace
    with it; ``late`` has its first gradient at step 2; ``bias`` (1-D) is
    never decayed. ``update`` returns the norm before the clip."""
    rs = np.random.RandomState(0)
    params = {"used": rs.randn(6, 5).astype(np.float32),
              "late": rs.randn(4, 5).astype(np.float32),
              "unused": rs.randn(5, 3).astype(np.float32),
              "bias": rs.randn(7).astype(np.float32)}
    grads = _grads(rs, params)
    for step, (want, got) in enumerate(_run_sgd(params, grads, clip)):
        err = np.abs(got[name] - want[name])
        bound = 1e-6 + 1e-6 * np.abs(want[name])
        assert (err <= bound).all(), (
            f"{name} after step {step + 1}: max abs {err.max():.3e}")
    if name in ("unused", "bias"):
        moved = np.abs(got[name] - params[name]).max()
        assert (moved > 0) == (name == "unused")


# ---------------------------------------------------------------------------
# the whole train step, f64 compute
# ---------------------------------------------------------------------------

def _jax_step(jm, variables, batch, key):
    """The reference's loss, its gradient with respect to the parameters
    and the mutated BN statistics, jitted, with ``key`` as the sampling
    key."""
    params = variables["params"]

    def loss_fn(p, stats, b):
        (total, parts), mutated = jm.apply(
            {"params": p, "batch_stats": stats}, b, train=True,
            method=jm.loss, mutable=["batch_stats"], rngs={"sampling": key})
        return total, (parts, mutated["batch_stats"])

    (total, (parts, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            params, variables["batch_stats"], batch)
    tx = jax_sgd(LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    return jax.device_get(dict(total=total, parts=parts, grads=grads,
                               stats=new_stats, params=new_params))


@pytest.fixture(scope="module")
def step():
    """One train step of the tiny Mask R-CNN and of the tiny Faster R-CNN
    (the same variables without the mask head) on both sides, f64 compute
    over f32 parameters, on the reference's draws and proposals."""
    batch = synthetic_detection_batch(STEP_BATCH, (64, 64), 5,
                                      with_masks=True, slots=SLOTS)
    out = {}
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jm = JMRCNN(**TINY, dtype=jnp.float64)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jb["image"], method=jm.predict))
        variables = random_variables({k: dict(v) for k, v in shapes.items()},
                                     0, gains={"cls": CLS_GAIN})
        key = jax.random.PRNGKey(KEY)
        # make_rng("sampling") at the root, as the first call inside loss
        sampling = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                            rngs={"sampling": key})
        b = batch["image"].shape[0]
        rk = jax.random.split(sampling, b * 2).reshape(b, 2, -1)

        def stages(m, image):
            _, logits, deltas = m(image, train=True)
            anchors, sizes = m._anchors()
            props, _ = j_props(logits, deltas, anchors, sizes, m.image_hw,
                               m.rpn_pre_nms, m.rpn_post_nms)
            return props

        props, _ = jax.jit(lambda v, x: jm.apply(
            v, x, method=stages, mutable=["batch_stats"]))(variables,
                                                           jb["image"])
        a = sum((64 // st) ** 2 * 3 for st in (4, 8, 16, 32, 64))
        n = props.shape[1] + SLOTS
        draws = {"rpn": _t(np.stack([_draws(rk[i, 0], a) for i in range(b)])),
                 "roi": _t(np.stack([_draws(rk[i, 1], n, unsplit=True)
                                     for i in range(b)]))}
        out["mask"] = _jax_step(jm, variables, jb, key)
        faster = {"params": {k: v for k, v in variables["params"].items()
                             if k != "mask_head"},
                  "batch_stats": variables["batch_stats"]}
        jf = JFRCNN(**TINY, dtype=jnp.float64)
        fb = {k: v for k, v in jb.items() if k != "gt_bitmaps"}
        out["faster"] = _jax_step(jf, faster, fb, key)
    out["variables"] = {"mask": variables, "faster": faster}
    proposals = _t(props)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["draws"] = draws
    for name, cls, convert in (("mask", MaskRCNN, mask_rcnn_from_flax),
                               ("faster", FasterRCNN, faster_rcnn_from_flax)):
        model = convert(cls(**TINY, dtype=torch.float64),
                        out["variables"][name])
        model = model.to(memory_format=torch.channels_last)
        model.proposals = lambda logits, deltas: (proposals, None, 0)
        old = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = TrainState.create(model, sgd(
            LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY))
        data = dict(tbatch) if name == "mask" else {
            k: v for k, v in tbatch.items() if k != "gt_bitmaps"}
        state, metrics = make_train_step(rcnn_loss)(state, data)
        out[f"port_{name}"] = dict(state=state, metrics=metrics, old=old,
                                   cls=cls, convert=convert)
    out["draws"], out["proposals"] = draws, proposals
    return out


MODELS = ["faster", "mask"]


def _reference_model(step, name, **collections):
    """The port's model of ``name`` holding the reference's
    ``collections`` (params, batch_stats) through the converter."""
    p = step[f"port_{name}"]
    variables = dict(step["variables"][name], **collections)
    return p["convert"](p["cls"](**TINY), variables)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_losses_match_jax(step, name):
    """The total and every part rtol 1e-6; on this batch the RPN and the
    ROI sampler have positives, so every part is above 0."""
    ref, metrics = step[name], step[f"port_{name}"]["metrics"]
    parts = {"rpn_cls", "rpn_reg", "roi_cls", "roi_reg"} | (
        {"mask"} if name == "mask" else set())
    assert set(metrics) == parts | {"loss", "grad_norm"}
    assert set(ref["parts"]) == parts
    np.testing.assert_allclose(float(metrics["loss"]), float(ref["total"]),
                               rtol=1e-6)
    for k in parts:
        np.testing.assert_allclose(float(metrics[k]), float(ref["parts"][k]),
                                   rtol=1e-6, err_msg=k)
        assert float(ref["parts"][k]) > 0, k
    grad_norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in
                            jax.tree_util.tree_leaves(ref["grads"])))
    np.testing.assert_allclose(float(metrics["grad_norm"]), grad_norm,
                               rtol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_gradients_match_jax(step, name):
    """Every parameter's gradient within 1e-5 relative L2 of the
    reference's, exactly 0 where the reference's is (the level P5 and P6
    convs when no sampled anchor and no roi lies there), and nearly every
    parameter reached (the RPN through its own losses only: the proposals
    are detached)."""
    ref = _reference_model(step, name, params=step[name]["grads"])
    model = step[f"port_{name}"]["state"].model
    refs = dict(ref.named_parameters())
    errs, reached = {}, 0
    for n, p in model.named_parameters():
        r = refs[n].detach().double()
        assert p.grad is not None, n
        errs[n] = float((p.grad.double() - r).norm() / r.norm().clamp_min(
            1e-30))
        reached += bool(r.abs().max() > 0)
    bad = {n: e for n, e in errs.items() if e > 1e-5}
    assert not bad, bad
    assert reached >= 0.9 * len(errs)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_bn_statistics_match_jax(step, name):
    """Every BN running mean and variance after the train-mode forward
    (momentum 0.9 in flax's sense) atol 1e-6, and each moved."""
    ref = _reference_model(step, name, batch_stats=step[name]["stats"])
    before = _reference_model(step, name)
    model = step[f"port_{name}"]["state"].model
    got = dict(model.named_buffers())
    old = dict(before.named_buffers())
    for n, r in ref.named_buffers():
        if n.endswith("num_batches_tracked") or n == "anchors":
            continue
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        assert float((r - old[n]).abs().max()) > 1e-5, n


@pytest.mark.parametrize("name", MODELS)
def test_sgd_step_matches_optax(step, name):
    """The parameters after one SGD step (the trace starts at the
    gradient plus the decay of ndim > 1 parameters) atol 1e-6 of the
    reference's optax update; every ndim > 1 parameter moved (the decay
    moves it where no gradient reaches it)."""
    ref = _reference_model(step, name, params=step[name]["params"])
    p = step[f"port_{name}"]
    got = dict(p["state"].model.named_parameters())
    for n, r in ref.named_parameters():
        np.testing.assert_allclose(got[n].detach().numpy(),
                                   r.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
        if r.ndim > 1:
            assert float((got[n].detach() - p["old"][n]).abs().max()) > 0, n


def test_sampling_draws_have_the_reference_shapes(step):
    """``sampling_draws`` makes what the reference's keys give: per image
    2 x A for the RPN and 3 x (K + G) for the ROI sampler, uniform in [0,
    1), on the generator's device."""
    model = step["port_mask"]["state"].model
    draws = model.sampling_draws(STEP_BATCH, SLOTS,
                                 torch.Generator().manual_seed(0))
    for k in ("rpn", "roi"):
        assert draws[k].shape == step["draws"][k].shape, k
        assert draws[k].dtype == torch.float32
        assert float(draws[k].min()) >= 0 and float(draws[k].max()) < 1
    assert model.num_proposals() == step["proposals"].shape[1] == 32


# ---------------------------------------------------------------------------
# the synthetic batch and the entries
# ---------------------------------------------------------------------------

def test_synthetic_batch_is_the_reference_generators_first():
    """Draw for draw the first batch of ``train/train.py:
    synthetic_detection_batches`` (max_objs 16), padded to 64 slots: the
    drawn slots equal, the padding empty."""
    from minddet_tpu.train.train import synthetic_detection_batches

    ref = next(synthetic_detection_batches(3, (64, 96), 80, seed=5,
                                           with_masks=True))
    got = synthetic_detection_batch(3, (64, 96), 80, seed=5,
                                    with_masks=True, slots=64)
    np.testing.assert_array_equal(got["image"], ref["image"])
    for k in ("gt_boxes", "gt_classes", "gt_mask"):
        np.testing.assert_array_equal(got[k][:, :16], ref[k], err_msg=k)
        assert not got[k][:, 16:].any(), k
    np.testing.assert_array_equal(got["gt_bitmaps"][..., :16],
                                  ref["gt_bitmaps"])
    assert got["gt_bitmaps"].shape == (3, 16, 24, 64)
    assert not got["gt_bitmaps"][..., 16:].any()
    n = got["gt_mask"].sum(1)
    assert ((n >= 2) & (n <= 15)).all()


def test_rcnn_train_entries_without_gpu_raise():
    from minddet_tpu_torch.entry import (faster_rcnn_train_entry,
                                         mask_rcnn_train_entry)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entries run there")
    for fn in (faster_rcnn_train_entry, mask_rcnn_train_entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_rcnn_train_program_configuration_on_cpu():
    """The Mask R-CNN train program, built (not run: it is full size) on
    the CPU when asked: f32 parameters, bf16 compute, train mode, 256 ROI
    samples, mask stride 4; SGD lr 0.01, momentum 0.9, weight decay 1e-4 on
    ndim > 1 parameters only, no clip; batch 8 with 64 GT slots and the
    bitmaps (8, 128, 128, 64), and a generator for the draws."""
    from minddet_tpu_torch.entry import mask_rcnn_train_entry

    _, (state, batch) = mask_rcnn_train_entry(device="cpu")
    model, opt, tx = state.model, state.optimizer, state.tx
    assert model.training and model.dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    assert (model.roi_samples, model.mask_stride, model.rpn_post_nms) == (
        256, 4, 512)
    assert isinstance(opt, torch.optim.SGD) and tx.clip_global_norm is None
    decayed, plain = opt.param_groups
    assert decayed["weight_decay"] == 1e-4 and plain["weight_decay"] == 0.0
    assert all(p.ndim > 1 for p in decayed["params"])
    assert all(p.ndim <= 1 for p in plain["params"])
    assert decayed["lr"] == 0.01 and decayed["momentum"] == 0.9
    assert batch["image"].shape == (8, 512, 512, 3)
    assert batch["gt_boxes"].shape == (8, 64, 4)
    assert batch["gt_bitmaps"].shape == (8, 128, 128, 64)
    assert isinstance(batch["generator"], torch.Generator)
    draws = model.sampling_draws(8, 64, batch["generator"])
    assert draws["rpn"].shape == (8, 2, 65472)
    assert draws["roi"].shape == (8, 3, 512 + 64)
