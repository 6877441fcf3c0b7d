"""The port's SSD-300-MobileNetV2 serving path vs the JAX package's, on the
CPU.

``ssd_anchors`` and the maps' sizes exactly (at 300 and at the small test
sizes). Each module alone at f64 compute: ``InvertedResidual`` (with and
without the expand conv, at stride 2, and with the residual; train mode
with flax's BN momentum 0.9 and eps 1e-5, the statistics' update
included), ``MobileNetV2`` (both taps), ``ExtraBlock`` and the multibox
heads, every output within 1e-9 of its largest value. Then SSD itself at
96x96, batch 2, 4 classes (MobileNetV2 has no width to cut here: the
full-width network on a small image) through ``ssd_from_flax``: the class
logits and box deltas, cast to f32 on both sides as the reference casts
them, within f32 rounding (rtol 2**-22), and ``predict`` (softmax without
the background, decode, clip, top 400, class-aware NMS 0.45 over 0.05)
slot by slot. ``calibrate_ssd`` on the tiny model. The JAX side runs
jitted; the flax variables are numpy-random (kernels at fan-in scale, BN
off identity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8 import (F32_ROUNDING, F64_RTOL, _assert_close, _f64,
                               _flax_variables, _maps, _nchw, _nhwc)

from minddet_tpu.models.backbones import mobilenet as jmbv2
from minddet_tpu.models.detectors import ssd as jssd
from minddet_tpu_torch import entry
from minddet_tpu_torch.models.backbones import mobilenet as tmbv2
from minddet_tpu_torch.models.detectors import ssd as tssd
from minddet_tpu_torch.utils.convert import load_from_flax, ssd_from_flax

RES = 96
TINY = dict(num_classes=4, image_size=RES)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size", [300, 96, 64])
def test_anchors_match_jax_exactly(size):
    """The maps' sizes (19, 10, 5, 3, 2, 1 at 300) and the anchors, f32
    pixels, bit for bit with the per-level counts (3000 at 300)."""
    jm, tm = jssd.SSD(image_size=size), tssd.SSD(image_size=size)
    assert tm.feature_sizes() == jm._feature_sizes()
    (want, want_counts), (got, counts) = jm.anchors(), tm.anchors()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert counts == want_counts
    if size == 300:
        assert tm.feature_sizes() == [19, 10, 5, 3, 2, 1]
        assert got.shape == (3000, 4)
    (dev,) = tm.anchor_boxes("cpu")
    assert dev.dtype == torch.float32 and np.array_equal(dev.numpy(), want)
    assert tssd.SSD_REG_STDS == jssd.SSD_REG_STDS


# (JAX module, port module, input map (H = W, C)): f64 compute
MODULES = {
    "inverted_residual_s2": (
        lambda: jmbv2.InvertedResidual(24, 2, 6, dtype=jnp.float64),
        lambda: tmbv2.InvertedResidual(16, 24, 2, 6), (12, 16)),
    "inverted_residual_no_expand": (
        lambda: jmbv2.InvertedResidual(16, 1, 1, dtype=jnp.float64),
        lambda: tmbv2.InvertedResidual(32, 16, 1, 1), (9, 32)),
    "inverted_residual_residual": (
        lambda: jmbv2.InvertedResidual(16, 1, 6, dtype=jnp.float64),
        lambda: tmbv2.InvertedResidual(16, 16, 1, 6), (9, 16)),
    "mobilenet_v2": (lambda: jmbv2.MobileNetV2(dtype=jnp.float64),
                     lambda: tmbv2.MobileNetV2(), (64, 3)),
    "extra_block": (lambda: jssd.ExtraBlock(32, dtype=jnp.float64),
                    lambda: tssd.ExtraBlock(48, 32), (5, 48)),
    "multibox": (lambda: jssd._MultiboxLayer(6, 4, dtype=jnp.float64),
                 lambda: tssd.MultiboxLayer(24, 6, 4), (5, 24)),
}


def _flat(ref):
    """A module's outputs: NHWC maps (to compare as NCHW) or (B, N, K)
    rows."""
    return ref if isinstance(ref, tuple) else (ref,)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_f64(name):
    """Eval mode, f64 compute: every output within 1e-9 of its largest
    value; MobileNetV2's ``out_channels`` are its taps'."""
    make_j, make_t, (hw, c) = MODULES[name]
    rs = np.random.RandomState(sorted(MODULES).index(name))
    (x,) = _maps(rs, 2, (hw,), (c,))
    jm = make_j()
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref = jax.device_get(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = load_from_flax(make_t().double(), variables).eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    refs, gots = _flat(ref), _flat(got)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        g = _nhwc(g) if g.dim() == 4 else g.numpy()
        assert g.shape == r.shape
        _assert_close(g, r, F64_RTOL)
    if hasattr(tm, "out_channels"):
        assert tm.out_channels == tuple(r.shape[-1] for r in refs)


def test_inverted_residual_train_mode_matches_jax_f64():
    """Train mode: the output from the batch's statistics, and the running
    statistics of the three BNs after one step of flax's momentum 0.9
    (torch's 0.1, eps 1e-5), within 1e-9."""
    x = np.random.RandomState(7).randn(2, 10, 10, 8) * 3 + 0.5
    jm = jmbv2.InvertedResidual(8, 1, 6, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref, mutated = jax.jit(lambda v, a: jm.apply(
            v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        ref, stats = jax.device_get((ref, mutated["batch_stats"]))
    tm = load_from_flax(tmbv2.InvertedResidual(8, 8, 1, 6).double(),
                        variables)
    assert (tm.dw_bn.momentum, tm.dw_bn.eps) == (0.1, 1e-5)
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    _assert_close(_nhwc(got), ref, F64_RTOL)
    for name in ("expand_bn", "dw_bn", "project_bn"):
        bn = getattr(tm, name)
        _assert_close(bn.running_mean.numpy(), stats[name]["mean"], F64_RTOL)
        _assert_close(bn.running_var.numpy(), stats[name]["var"], F64_RTOL)


def _shapes():
    jm = jssd.SSD(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, RES, RES, 3))))
    return {k: dict(v) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def variables():
    return random_variables(_shapes(), 9)


@pytest.fixture(scope="module")
def served(variables):
    """The f64 comparison, the JAX side jitted once: the heads' outputs and
    ``predict`` of both sides."""
    variables = _f64(variables)
    image = np.random.RandomState(10).rand(2, RES, RES, 3)
    jm = jssd.SSD(**TINY, dtype=jnp.float64)
    with jax.enable_x64(True):
        outs, pred = jax.device_get(jax.jit(lambda v, x: (
            jm.apply(v, x), jm.apply(v, x, method=jm.predict)))(
                variables, jnp.asarray(image)))
    tm = ssd_from_flax(tssd.SSD(**TINY, dtype=torch.float64).double(),
                       variables).eval()
    with torch.no_grad():
        got_outs = tm(torch.from_numpy(image))
    got = tm.predict(torch.from_numpy(image))
    return dict(outs=outs, pred=pred, got_outs=got_outs, got=got)


def test_heads_match_jax_f64(served):
    """Class logits (2, A, 5) and box deltas (2, A, 4), f32 on both sides,
    within f32 rounding; A = 6 (36 + 9 + 4 + 1 + 1 + 1)."""
    for g, r, k in zip(served["got_outs"], served["outs"], (5, 4)):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == (2, 312, k)
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)


def test_predict_matches_jax_f64(served):
    """``predict``: the labels, and so the kept set (-1 padded), equal slot
    by slot, boxes within f32 rounding, scores (a softmax of f32 logits on
    each side) within 1e-6 relative."""
    got, ref = served["got"], served["pred"]
    assert got["labels"].shape == (2, 100)
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=F32_ROUNDING, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=1e-6, atol=1e-30)
    kept = ref["labels"] >= 0
    assert kept.sum(1).min() > 0


def test_ssd_from_flax_is_a_bijection(variables):
    """Every flax leaf lands in one port tensor: the counts agree, the
    depthwise kernels (3, 3, 1, C) arrive as (C, 1, 3, 3), a leaf missing
    raises."""
    tm = ssd_from_flax(tssd.SSD(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    k = variables["params"]["backbone"]["block3"]["dw"]["kernel"]
    assert k.shape[2] == 1 and tm.backbone.block3.dw.groups == k.shape[3]
    np.testing.assert_array_equal(tm.backbone.block3.dw.weight.detach()
                                  .numpy(), np.transpose(k, (3, 2, 0, 1)))
    missing = {c: dict(v) for c, v in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items()
                         if k != "extra2"}
    with pytest.raises(KeyError, match="missing"):
        ssd_from_flax(tssd.SSD(**TINY), missing)


def test_calibrate_ssd_spreads_the_class_logits():
    """The seeded tiny SSD's class scores lie near 1 / (C + 1); after
    ``calibrate_ssd`` on an image every map's class logits have std 2 on
    it, the biases and box deltas are as they were, and ``predict`` keeps
    boxes over the 0.05 threshold."""
    model = tssd.SSD(num_classes=80, image_size=64).init_weights(
        torch.Generator().manual_seed(0)).eval()
    image = torch.rand(1, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(1))
    with torch.no_grad():
        reg_before = model(image)[1]
        before = model.candidates(*model(image))["scores"]
    assert float(before.max()) < 0.05
    entry.calibrate_ssd(model, image)
    with torch.no_grad():
        for i, f in enumerate(model.features(image)):
            layer = getattr(model, f"multibox{i}")
            assert float(layer(f)[0].std()) == pytest.approx(2.0, rel=1e-4)
            assert bool((layer.cls.bias == 0).all())
        assert torch.equal(model(image)[1], reg_before)
    det = model.predict(image)
    assert int((det["labels"] >= 0).sum()) > 0


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.ssd_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.ssd_train_entry()


def test_build_ssd_on_cpu_when_asked():
    """``build_ssd`` (``ssd_entry``'s model before its calibration, which
    runs a request's forward: that is for the card): SSD-300, 80 classes,
    bf16 parameters and compute, channels_last, eval mode, as many
    parameters as the reference's, the anchors f32 and equal to the
    reference's 3000."""
    model = entry.build_ssd("cpu")
    assert not model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.multibox0.cls.weight.is_contiguous(
        memory_format=torch.channels_last)
    shapes = jax.eval_shape(lambda: jssd.SSD().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))["params"]
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(shapes))
    (anchors,) = model.anchor_boxes("cpu")
    assert anchors.dtype == torch.float32
    np.testing.assert_array_equal(anchors.numpy(), jssd.SSD().anchors()[0])
    assert model.multibox5.cls.weight.shape[0] == 6 * 81
