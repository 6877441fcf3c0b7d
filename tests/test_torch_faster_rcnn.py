"""The port's Faster R-CNN and Mask R-CNN inference path vs the JAX
package's, f32 on the CPU: anchors, box ops, NMS, ROIAlign, FPN, RPN head,
proposals, box and mask heads, and ``predict`` end to end.

Inputs and flax variables are drawn with numpy from seeds (kernels N(0,
1 / fan_in), BN scales and variances in [0.6, 1.4), biases and means N(0,
0.01); ``tests/test_torch_resnet_bottleneck.py:random_variables``) and
carried over by ``faster_rcnn_from_flax`` / ``mask_rcnn_from_flax``. JAX
runs on the CPU on its XLA paths (the row gather's plain reference); the
port runs its plain versions. The model is the JAX fixture's size
(``tests/test_faster_rcnn.py``): depth 18, 64 x 64, 5 classes, pre-NMS top
64, post-NMS 32. Its box head's ``cls`` kernel is scaled by ``CLS_GAIN`` on
both sides, the same flax leaf, so that the softmax scores spread over (0,
1) and detections pass the 0.05 threshold.

Tolerances (atol, rtol): anchors exact; box decode and clip 1e-5; NMS kept
lists identical; ROIAlign 1e-5 (the same bilinear weights and four-term
f32 sums); modules (FPN, RPN head, box head, mask head) 1e-4 (f32 convs
and matmuls summed in another order); each discrete stage (per-level
top-k, NMS, final top-k) on the JAX side's own inputs: identical choices,
boxes 1e-4. End to end the port's stages feed each other, so the 18-layer
backbone's rounding reaches the heads: labels identical, boxes and scores
at rtol 1e-4, with atol 1e-3 px on boxes (an RPN or box delta's 1e-5
rounding times an anchor or roi of up to 64 px) and 1e-4 on scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.models.detectors.faster_rcnn import FasterRCNN as JFRCNN
from minddet_tpu.models.detectors.faster_rcnn import MaskRCNN as JMRCNN
from minddet_tpu.models.heads.roi_head import box_head_predict as j_predict
from minddet_tpu.models.heads.rpn_head import generate_proposals as j_props
from minddet_tpu.ops import anchors2d as ja
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops import nms as jnms
from minddet_tpu.ops import roi_align as jroi
from minddet_tpu_torch.models.detectors.faster_rcnn import (FasterRCNN,
                                                             MaskRCNN)
from minddet_tpu_torch.models.heads.roi_head import box_head_predict
from minddet_tpu_torch.models.heads.rpn_head import generate_proposals
from minddet_tpu_torch.ops import anchors2d as ta
from minddet_tpu_torch.ops import box as tbox
from minddet_tpu_torch.ops import nms as tnms
from minddet_tpu_torch.ops import roi_align as troi
from minddet_tpu_torch.utils.convert import (faster_rcnn_from_flax,
                                             mask_rcnn_from_flax)
from test_torch_resnet_bottleneck import random_variables

TINY = dict(num_classes=5, depth=18, image_hw=(64, 64), rpn_pre_nms=64,
            rpn_post_nms=32)
CLS_GAIN = 0.5
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rs, shape, lo=0.0, hi=60.0, min_wh=0.0, max_wh=30.0):
    xy = rs.uniform(lo, hi, shape + (2,))
    wh = rs.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# anchors and box ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw, stride, scales, ratios", [
    ((3, 5), 8, (8.0,), (0.5, 1.0, 2.0)),
    ((4, 4), 16, (1.0, 2.0), (1.0,)),
    ((1, 1), 64, (8.0,), (0.5, 1.0, 2.0)),
])
def test_grid_anchors_match_jax(hw, stride, scales, ratios):
    got = ta.grid_anchors(hw, stride, scales, ratios)
    ref = ja.grid_anchors(hw, stride, scales, ratios)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("image_hw", [(64, 64), (512, 512), (100, 75)])
def test_multilevel_anchors_match_jax(image_hw):
    strides = (4, 8, 16, 32, 64)
    got = ta.multilevel_anchors(image_hw, strides)
    np.testing.assert_array_equal(
        got, np.asarray(ja.multilevel_anchors(image_hw, strides)))
    per_level = ta.multilevel_anchors(
        image_hw, strides[:2], scales_per_level=((4.0,), (8.0, 16.0)))
    np.testing.assert_array_equal(per_level, np.asarray(ja.multilevel_anchors(
        image_hw, strides[:2], scales_per_level=((4.0,), (8.0, 16.0)))))


def test_decode_deltas_and_clip_match_jax():
    rs = np.random.RandomState(0)
    anchors = _boxes(rs, (300,), -10, 70, 0.5, 40)
    deltas = (rs.randn(300, 4) * 2).astype(np.float32)
    deltas[:10, 2:] = [[5.0, -5.0]] * 10  # past the log(16) clamp
    for stds in ((1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)):
        got = tbox.decode_deltas(_t(deltas), _t(anchors), stds=stds)
        ref = jbox.decode_deltas(jnp.asarray(deltas), jnp.asarray(anchors),
                                 stds=stds)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        clipped = tbox.clip_boxes(got, 48, 64)
        np.testing.assert_allclose(
            clipped.numpy(), np.asarray(jbox.clip_boxes(ref, 48, 64)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tbox.pairwise_iou(_t(anchors[:40]), _t(anchors[40:90])).numpy(),
        np.asarray(jbox.pairwise_iou(jnp.asarray(anchors[:40]),
                                     jnp.asarray(anchors[40:90]))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tbox.area(_t(anchors)).numpy(),
                                  np.asarray(jbox.area(jnp.asarray(anchors))))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _nms_inputs(seed, n=120, ties=True, neg_inf=True):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, (n,), 0, 40, 2, 20)
    scores = rs.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores[5:25] = 0.5                    # one big tie
        boxes[30:34] = boxes[30]              # identical boxes, tied
        scores[30:34] = 0.7
    if neg_inf:
        scores[::9] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("score_threshold, max_outputs", [
    (float("-inf"), None), (0.2, 40)])
def test_nms_kept_lists_match_jax(threshold, score_threshold, max_outputs):
    """Ties (equal scores, identical boxes) and -inf scores: the same kept
    lists, batched over two samples where JAX takes one at a time."""
    pairs = [_nms_inputs(s) for s in (0, 1)]
    boxes = np.stack([p[0] for p in pairs])
    scores = np.stack([p[1] for p in pairs])
    got, count, _ = tnms.nms(_t(boxes), _t(scores), threshold,
                             score_threshold, max_outputs)
    for i, (b, s) in enumerate(pairs):
        ref, n = jnms.nms(jnp.asarray(b), jnp.asarray(s), threshold,
                          score_threshold, max_outputs)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
        assert int(count[i]) == int(n)


def test_batched_nms_per_image_span_matches_jax():
    """Two images whose boxes span very different ranges (0-40 and
    0-4000 px): each image's class offset is its own span, as inside the
    reference's vmap."""
    rs = np.random.RandomState(3)
    b0, s0 = _nms_inputs(4)
    b1 = _boxes(rs, (120,), 0, 4000, 10, 600)
    s1 = rs.uniform(0, 1, 120).astype(np.float32)
    s1[::11] = -np.inf
    classes = rs.randint(0, 4, (2, 120)).astype(np.int32)
    boxes, scores = np.stack([b0, b1]), np.stack([s0, s1])
    got, count, _ = tnms.batched_nms(_t(boxes), _t(scores), _t(classes),
                                     0.5, 0.05, 50)
    for i in range(2):
        ref, n = jnms.batched_nms(jnp.asarray(boxes[i]),
                                  jnp.asarray(scores[i]),
                                  jnp.asarray(classes[i]), 0.5, 0.05, 50)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
        assert int(count[i]) == int(n)


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------

def _rois(rs, b, r, hi, max_wh):
    rois = _boxes(rs, (b, r), -4, hi, 0, max_wh)
    rois[:, ::7] = 0.0                             # zero-padded rois
    rois[:, 3::7, 2:] = rois[:, 3::7, :2]          # zero-area rois
    rois[:, 5::7, 2] = rois[:, 5::7, 0] + 0.3      # thinner than 1
    return rois


@pytest.mark.parametrize("output_size, ratio", [((7, 7), 2), ((14, 14), 2),
                                                ((2, 3), 1)])
def test_roi_align_matches_jax(output_size, ratio):
    rs = np.random.RandomState(5)
    feat = rs.randn(2, 16, 12, 8).astype(np.float32)
    rois = _rois(rs, 2, 21, 14, 10)
    got = troi.roi_align(_t(feat), _t(rois), output_size, ratio)
    ref = jroi.roi_align(jnp.asarray(feat), jnp.asarray(rois), output_size,
                         ratio)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_multilevel_roi_align_matches_jax():
    """Four levels of a 512 x 512 image; rois from 0 to 500 px (every
    level is chosen), zero-padded and zero-area ones included."""
    rs = np.random.RandomState(6)
    strides = (4, 8, 16, 32)
    feats = [rs.randn(2, 512 // s, 512 // s, 4).astype(np.float32)
             for s in strides]
    rois = _rois(rs, 2, 42, 400, 500)
    got = troi.multilevel_roi_align([_t(f) for f in feats], _t(rois),
                                    strides, (7, 7))
    ref = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                    jnp.asarray(rois), strides, (7, 7))
    levels = troi.roi_levels(_t(rois), 4)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multilevel_roi_align_is_each_levels_roi_align(dtype):
    """The sample points of all levels, computed at once, are each level's
    own: every roi's features equal ``roi_align`` on its level's map at
    boxes / stride, bit for bit, rois thinner than a stride (where the
    clamp to one map pixel differs from level to level) included."""
    rs = np.random.RandomState(7)
    strides = (4, 8, 16, 32)
    feats = [_t(rs.randn(2, 512 // s, 512 // s, 8).astype(np.float32))
             .to(dtype) for s in strides]
    rois = _t(_rois(rs, 2, 42, 400, 500))
    got = troi.multilevel_roi_align(feats, rois, strides, (7, 7))
    levels = troi.roi_levels(rois, 4)
    want = torch.zeros_like(got)
    for li, (f, s) in enumerate(zip(feats, strides)):
        one = troi.roi_align(f, rois / s, (7, 7)).float()
        want = torch.where((levels == li)[..., None, None, None], one, want)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the detector's modules and stages
# ---------------------------------------------------------------------------

def _variables(jm, image, seed=0):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(image), method=jm.predict))
    return random_variables({k: dict(v) for k, v in shapes.items()}, seed,
                            gains={"cls": CLS_GAIN})


@pytest.fixture(scope="module")
def models():
    image = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jm = JMRCNN(**TINY)
    variables = _variables(jm, image)
    port = mask_rcnn_from_flax(MaskRCNN(**TINY).eval(), variables)

    def stages(mdl, x):
        pyr, logits, deltas = mdl(x)
        anchors, sizes = mdl._anchors()
        props, _ = j_props(logits, deltas, anchors, sizes, mdl.image_hw,
                           mdl.rpn_pre_nms, mdl.rpn_post_nms)
        feats = jroi.multilevel_roi_align(pyr[:4], props, mdl.strides[:4],
                                          (7, 7))
        cls, reg = mdl.box_head(feats)
        return dict(pyramids=pyr, logits=logits, deltas=deltas,
                    proposals=props, roi_feats=feats, cls=cls, reg=reg)

    ref = jax.jit(lambda v, x: jm.apply(v, x, method=stages))(
        variables, jnp.asarray(image))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return jm, variables, port, image, ref


def test_fpn_matches_jax(models):
    jm, variables, port, image, _ = models
    c = np.random.RandomState(7)
    feats = [c.randn(2, 64 // s, 64 // s, w).astype(np.float32)
             for s, w in zip((4, 8, 16, 32), port.backbone.out_channels)]
    ref = jax.jit(lambda v, f: jm.apply(
        v, f, method=lambda m, f: m.fpn(f)))(variables, feats)
    with torch.no_grad():
        got = port.fpn([_t(f).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last) for f in feats])
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        if i < 4:  # ROIAlign reads these NHWC views in place
            assert g.permute(0, 2, 3, 1).is_contiguous()
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), **MODULE_TOL,
                                   err_msg=f"P{i + 2}")


def test_rpn_head_matches_jax(models):
    jm, variables, port, _, ref = models
    pyr = ref["pyramids"]
    got_l, got_d = port.rpn([_t(p).permute(0, 3, 1, 2) for p in pyr])
    ref_l, ref_d = jax.jit(lambda v, f: jm.apply(
        v, f, method=lambda m, f: m.rpn(f)))(variables, pyr)
    assert got_l.shape == (2, port.anchors.shape[0])
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(ref_l),
                               **MODULE_TOL)
    np.testing.assert_allclose(got_d.detach().numpy(), np.asarray(ref_d),
                               **MODULE_TOL)


def test_box_and_mask_heads_match_jax(models):
    jm, variables, port, _, ref = models
    feats = ref["roi_feats"]
    with torch.no_grad():
        cls, reg = port.box_head(_t(feats))
    np.testing.assert_allclose(cls.numpy(), ref["cls"], **MODULE_TOL)
    np.testing.assert_allclose(reg.numpy(), ref["reg"], **MODULE_TOL)
    mfeats = np.random.RandomState(8).randn(2, 3, 14, 14, 256).astype(
        np.float32)
    jmask = jax.jit(lambda v, f: jm.apply(
        v, f, method=lambda m, f: m.mask_head(f)))(variables, mfeats)
    with torch.no_grad():
        tmask = port.mask_head(_t(mfeats))
    assert tmask.shape == (2, 3, 28, 28, 5)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask),
                               **MODULE_TOL)


def test_generate_proposals_on_jax_inputs(models):
    """The per-level top-k, decode, clip and NMS on JAX's own RPN outputs:
    the same proposals, zero-padded slots included."""
    jm, _, port, _, ref = models
    got, scores, _ = generate_proposals(
        _t(ref["logits"]), _t(ref["deltas"]), port.anchors, port.level_sizes,
        port.image_hw, port.rpn_pre_nms, port.rpn_post_nms)
    np.testing.assert_allclose(got.numpy(), ref["proposals"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal((got.abs().sum(-1) > 0).numpy(),
                                  np.abs(ref["proposals"]).sum(-1) > 0)


def test_generate_proposals_ties_and_padding():
    """Tied logits (the lower index first, as lax.top_k), -inf scores of
    degenerate boxes and fewer candidates than slots: JAX's kept indices,
    slot for slot."""
    rs = np.random.RandomState(9)
    anchors = ja.multilevel_anchors((32, 32), (8, 16))
    sizes = [48, 12]
    logits = np.round(rs.randn(2, 60), 1).astype(np.float32)  # many ties
    deltas = (rs.randn(2, 60, 4) * 0.3).astype(np.float32)
    deltas[:, ::5, 2] = -50.0  # clamped to 1/16 of the anchor
    for min_size, post in ((0.0, 40), (3.0, 80)):
        got, sc, _ = generate_proposals(_t(logits), _t(deltas),
                                        _t(anchors), sizes, (32, 32), 20,
                                        post, 0.6, min_size)
        ref, rsc = jax.vmap(lambda lg, dl: j_props(
            lg[None], dl[None], jnp.asarray(anchors), sizes, (32, 32), 20,
            post, 0.6, min_size))(jnp.asarray(logits), jnp.asarray(deltas))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sc.numpy(), np.asarray(rsc)[:, 0],
                                   rtol=1e-6, atol=1e-6)


def test_box_head_predict_on_jax_inputs(models):
    """Softmax, per-class decode, top-400 and class-aware NMS on JAX's own
    head outputs and proposals; then the same with every roi's logits
    made equal in pairs (exact ties across rois and classes)."""
    _, _, port, _, ref = models
    cls, reg, props = ref["cls"], ref["reg"], ref["proposals"]
    tied = cls.copy()
    tied[:, 1::2] = tied[:, ::2]
    for c in (cls, tied):
        got = box_head_predict(_t(c), _t(reg), _t(props), port.image_hw)
        want = j_predict(jnp.asarray(c), jnp.asarray(reg),
                         jnp.asarray(props), port.image_hw)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        np.testing.assert_allclose(got["boxes"].numpy(),
                                   np.asarray(want["boxes"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), rtol=1e-5,
                                   atol=1e-6)
        assert (got["labels"] >= 0).sum() > 0


def test_forward_stages_match_jax(models):
    """The port's forward, end to end: pyramids, RPN outputs and
    proposals; then ROI features and head outputs on the port's pyramids at
    JAX's proposals."""
    _, _, port, image, ref = models
    with torch.no_grad():
        pyr, logits, deltas = port(_t(image))
        props, _, _ = port.proposals(logits, deltas)
    for i, p in enumerate(pyr):
        np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(),
                                   ref["pyramids"][i], **MODULE_TOL,
                                   err_msg=f"P{i + 2}")
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **MODULE_TOL)
    np.testing.assert_allclose(deltas.numpy(), ref["deltas"], **MODULE_TOL)
    np.testing.assert_allclose(props.numpy(), ref["proposals"], rtol=1e-4,
                               atol=1e-3)
    # from here on JAX's proposals: the port's differ by up to ~1e-3 px,
    # which moves a sample by that times the map's slope
    with torch.no_grad():
        feats = port.roi_features(pyr, _t(ref["proposals"]), (7, 7))
        cls, reg = port.box_head(feats)
    np.testing.assert_allclose(feats.numpy(), ref["roi_feats"], **MODULE_TOL)
    np.testing.assert_allclose(cls.numpy(), ref["cls"], **MODULE_TOL)
    np.testing.assert_allclose(reg.numpy(), ref["reg"], **MODULE_TOL)


def _check_detections(got, want, masks=False):
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert (got["labels"] >= 0).sum() > 0
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-4,
                               atol=1e-4)
    if masks:
        assert got["masks"].shape == (2, 100, 28, 28)
        np.testing.assert_allclose(got["masks"].numpy(),
                                   np.asarray(want["masks"]), rtol=1e-4,
                                   atol=1e-4)


def test_mask_rcnn_predict_matches_jax(models):
    jm, variables, port, image, _ = models
    want = jax.jit(lambda v, x: jm.apply(v, x, method=jm.predict))(
        variables, jnp.asarray(image))
    got = port.predict(_t(image))
    assert len(got["nms_passes"]) == 2
    _check_detections(got, want, masks=True)


def test_faster_rcnn_predict_matches_jax(models):
    """The same weights without the mask head, through
    ``faster_rcnn_from_flax``, with other thresholds."""
    _, variables, _, image, _ = models
    jm = JFRCNN(**TINY)
    plain = {"params": {k: v for k, v in variables["params"].items()
                        if k != "mask_head"},
             "batch_stats": variables["batch_stats"]}
    port = faster_rcnn_from_flax(FasterRCNN(**TINY).eval(), plain)
    assert not hasattr(port, "mask_head")
    want = jax.jit(lambda v, x: jm.apply(v, x, 0.1, 0.4, 50,
                                         method=jm.predict))(
        plain, jnp.asarray(image))
    got = port.predict(_t(image), 0.1, 0.4, 50)
    assert got["boxes"].shape == (2, 50, 4)
    _check_detections(got, want)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entries_without_gpu_raise():
    from minddet_tpu_torch.entry import faster_rcnn_entry, mask_rcnn_entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entries run there")
    for fn in (faster_rcnn_entry, mask_rcnn_entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_build_configuration_on_cpu():
    """The serving configuration, built (not run: it is full size) on the
    CPU when asked: ResNet-50-FPN, 80 classes, 512 x 512, bf16, RPN top
    1000 per level and 512 after its NMS, 3 anchors per position."""
    from minddet_tpu_torch.entry import build_faster_rcnn
    from minddet_tpu_torch.models.backbones.resnet import Bottleneck

    model = build_faster_rcnn(device="cpu", with_mask=True)
    assert not model.training and model.dtype == torch.bfloat16
    assert model.with_mask and model.mask_head.out.out_channels == 80
    assert model.box_head.cls.out_features == 81
    assert model.box_head.fc1.in_features == 7 * 7 * 256
    assert model.backbone.out_channels == (256, 512, 1024, 2048)
    assert sum(isinstance(m, Bottleneck) for m in model.modules()) == 16
    assert (model.image_hw, model.rpn_pre_nms, model.rpn_post_nms) == (
        (512, 512), 1000, 512)
    assert model.level_sizes == [49152, 12288, 3072, 768, 192]
    assert tuple(model.anchors.shape) == (sum(model.level_sizes), 4)
    assert "anchors" not in model.state_dict()
    conv = model.backbone.layer1_0.conv2.weight
    assert conv.dtype == torch.bfloat16
    assert conv.is_contiguous(memory_format=torch.channels_last)


def test_calibrate_rcnn_spreads_the_heads():
    """``calibrate_rcnn`` on the tiny model: the RPN deltas, the class
    logits and the box deltas take their target stds on the image it saw,
    and the request keeps detections."""
    from minddet_tpu_torch import entry

    model = MaskRCNN(**dict(TINY, num_classes=80)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    image = torch.from_numpy(np.random.RandomState(2).randn(
        2, 64, 64, 3).astype(np.float32))
    entry.calibrate_rcnn(model, image)
    with torch.no_grad():
        pyr, logits, deltas = model(image)
        props, _, _ = model.proposals(logits, deltas)
        cls, reg = model.box_head(model.roi_features(pyr, props, (7, 7)))
    real = props.abs().sum(-1) > 0
    assert float(deltas.std()) == pytest.approx(entry.RPN_DELTA_STD,
                                                rel=1e-3)
    assert float(cls[real].std()) == pytest.approx(entry.CLS_LOGIT_STD,
                                                   rel=1e-3)
    assert float(reg[real].std()) == pytest.approx(entry.BOX_DELTA_STD,
                                                   rel=1e-3)
    out = model.predict(image)
    assert bool(((out["labels"] >= 0).sum(1) > 0).all())
    assert bool(((out["masks"] >= 0) & (out["masks"] <= 1)).all())
