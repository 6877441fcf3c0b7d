"""The port's YOLOv8 serving path vs the JAX package's, on the CPU.

A tiny YOLOv8 (width 0.125, depth 0.33, 4 classes, 64x64: A = 84 anchor
points) and each of its modules alone: ``ConvBlock`` (eval and train mode,
the BN statistics' update included), ``Bottleneck`` with both kernel pairs
and with unequal widths (no shortcut), ``CSPLayer``, ``C2f``, ``SPPF``,
``CSPDarknet`` in both flavours, ``C2fPAN`` and ``YOLOv8Head``; ``_up2``,
``yolo_grid``, ``dfl_decode`` and ``predict``. The flax variables are
numpy-random (kernels at fan-in scale, BN off identity) and go to the port
through ``load_from_flax`` / ``yolov8_from_flax``; the JAX side runs
jitted.

Tolerances: with f64 compute, every map of the network within 1e-9 of its
largest value; the head's outputs, cast to f32 on both sides as the
reference casts them, and what follows them (decode, top-k, NMS) within
f32 rounding (rtol 2**-22), the kept sets equal. With f32 compute the
logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables

from minddet_tpu.models.backbones import csp_darknet as jcsp
from minddet_tpu.models.detectors import yolov8 as jyolo
from minddet_tpu.models.detectors.yolox import yolo_grid as j_yolo_grid
from minddet_tpu.models.necks import pan as jpan
from minddet_tpu_torch.entry import YOLO_RES, build_yolov8, yolov8_entry
from minddet_tpu_torch.models.backbones import csp_darknet as tcsp
from minddet_tpu_torch.models.detectors import yolov8 as tyolo
from minddet_tpu_torch.models.detectors.yolox import yolo_grid
from minddet_tpu_torch.models.necks import pan as tpan
from minddet_tpu_torch.utils.convert import load_from_flax, yolov8_from_flax

TINY = dict(num_classes=4, image_hw=(64, 64), width_mult=0.125,
            depth_mult=0.33)
F64_RTOL = 1e-9
F32_ROUNDING = 2.0 ** -22  # two f32 ulps, relative


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's tensors are small: one intra-op thread is faster
    for them than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _flax_variables(module, *inputs, seed=0):
    """numpy-random variables of ``module`` at ``inputs`` (eval mode), in
    f64."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *inputs))
    return _f64(random_variables({k: dict(v) for k, v in shapes.items()},
                                 seed))


def _f64(variables):
    """The variables widened to f64: flax's eval-mode BN computes
    rsqrt(var + eps) in the statistics' dtype, so f32 statistics would
    leave the reference's f64 compute with an f32 multiplier."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  variables)


def _assert_close(got, want, rtol):
    """|got - want| <= rtol * max |want| (a map's largest value)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, rtol)


def _maps(rs, batch, hw, channels):
    return [rs.randn(batch, h, h, c) for h, c in zip(hw, channels)]


# (JAX module, port module, input maps (H = W, C)): each at f64 compute
MODULES = {
    "conv_block_s2": (lambda: jcsp.ConvBlock(24, 3, 2, dtype=jnp.float64),
                      lambda: tcsp.ConvBlock(16, 24, 3, 2), [(16, 16)]),
    "bottleneck_1_3": (lambda: jcsp.Bottleneck(16, dtype=jnp.float64),
                       lambda: tcsp.Bottleneck(16, 16), [(12, 16)]),
    "bottleneck_3_3": (lambda: jcsp.Bottleneck(16, kernels=(3, 3),
                                               dtype=jnp.float64),
                       lambda: tcsp.Bottleneck(16, 16, True, (3, 3)),
                       [(12, 16)]),
    "bottleneck_widths_differ": (
        lambda: jcsp.Bottleneck(24, dtype=jnp.float64),
        lambda: tcsp.Bottleneck(16, 24), [(12, 16)]),
    "csp_layer": (lambda: jcsp.CSPLayer(32, 2, dtype=jnp.float64),
                  lambda: tcsp.CSPLayer(16, 32, 2), [(12, 16)]),
    "c2f": (lambda: jcsp.C2f(32, 2, dtype=jnp.float64),
            lambda: tcsp.C2f(16, 32, 2), [(12, 16)]),
    "c2f_no_shortcut": (lambda: jcsp.C2f(32, 1, False, dtype=jnp.float64),
                        lambda: tcsp.C2f(24, 32, 1, False), [(12, 24)]),
    "sppf": (lambda: jcsp.SPPF(32, dtype=jnp.float64),
             lambda: tcsp.SPPF(48, 32), [(9, 48)]),
    "csp_darknet_c2f": (
        lambda: jcsp.CSPDarknet(0.33, 0.125, use_c2f=True,
                                dtype=jnp.float64),
        lambda: tcsp.CSPDarknet(0.33, 0.125, use_c2f=True), [(64, 3)]),
    "csp_darknet_csp": (
        lambda: jcsp.CSPDarknet(0.33, 0.125, dtype=jnp.float64),
        lambda: tcsp.CSPDarknet(0.33, 0.125), [(64, 3)]),
    "c2f_pan": (lambda: jpan.C2fPAN((32, 64, 128), 1, dtype=jnp.float64),
                lambda: tpan.C2fPAN((32, 64, 128), (32, 64, 128), 1),
                [(8, 32), (4, 64), (2, 128)]),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_f64(name):
    """Eval mode, f64 compute: every output map within 1e-9 of its
    largest value."""
    make_j, make_t, spec = MODULES[name]
    rs = np.random.RandomState(sorted(MODULES).index(name))
    x = _maps(rs, 2, *zip(*spec))
    jm = make_j()
    with jax.enable_x64(True):
        xs = [jnp.asarray(a) for a in x]
        # a multi-input module takes its maps as one tuple
        args = (tuple(xs),) if len(xs) > 1 else tuple(xs)
        variables = _flax_variables(jm, *args)
        ref = jax.device_get(jax.jit(lambda v, *a: jm.apply(v, *a))(
            variables, *args))
    tm = load_from_flax(make_t().double(), variables).eval()
    targs = [_nchw(a) for a in x]
    with torch.no_grad():
        got = tm(targs if len(targs) > 1 else targs[0])
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        assert g.shape == _nchw(r).shape
        _assert_close(_nhwc(g), r, F64_RTOL)


def test_conv_block_train_mode_matches_jax_f64():
    """Train mode: the output from the batch's statistics, and the running
    statistics after one step of flax's momentum 0.97 (torch's 0.03),
    within 1e-9."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 10, 10, 8) * 2 + 0.5
    jm = jcsp.ConvBlock(12, 3, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref, mutated = jax.jit(lambda v, a: jm.apply(
            v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        ref, stats = jax.device_get((ref, mutated["batch_stats"]["bn"]))
    tm = load_from_flax(tcsp.ConvBlock(8, 12, 3).double(), variables)
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    _assert_close(_nhwc(got), ref, F64_RTOL)
    _assert_close(tm.bn.running_mean.numpy(), stats["mean"], F64_RTOL)
    _assert_close(tm.bn.running_var.numpy(), stats["var"], F64_RTOL)
    assert np.abs(stats["mean"] - variables["batch_stats"]["bn"]["mean"]
                  ).max() > 1e-3


def test_up2_matches_jax():
    """Nearest x2 upsampling: exactly ``jax.image.resize(..., "nearest")``
    at twice the size."""
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jpan._up2(jnp.asarray(x)))
    got = _nhwc(tpan.up2(_nchw(x)))
    assert got.shape == (2, 10, 14, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,strides", [((64, 64), (8, 16, 32)),
                                        ((96, 64), (8, 16, 32)),
                                        ((640, 640), (8, 16, 32))])
def test_yolo_grid_matches_jax(hw, strides):
    for got, ref in zip(yolo_grid(hw, strides), j_yolo_grid(hw, strides)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_dfl_decode_matches_jax():
    """Random logits, f64 on both sides: 1e-9; the uniform distribution's
    expectation is 7.5 bins a side (``test_dfl_decode_monotonic``'s case:
    [-28, -28, 92, 92] around (32, 32) at stride 8)."""
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 84, 4, 16) * 3
    pts, sts = j_yolo_grid((64, 64))
    with jax.enable_x64(True):
        ref = np.asarray(jyolo.dfl_decode(jnp.asarray(logits),
                                          jnp.asarray(pts, jnp.float64)[None],
                                          jnp.asarray(sts, jnp.float64)[None]))
    got = tyolo.dfl_decode(torch.from_numpy(logits),
                           torch.from_numpy(pts).double()[None],
                           torch.from_numpy(sts).double()[None])
    _assert_close(got.numpy(), ref, F64_RTOL)
    uniform = tyolo.dfl_decode(torch.zeros(1, 1, 4, 16),
                               torch.tensor([[[32.0, 32.0]]]),
                               torch.tensor([[8.0]]))
    np.testing.assert_allclose(uniform[0, 0].numpy(), [-28, -28, 92, 92],
                               atol=1e-3)


def _tiny_variables(seed=3):
    """numpy-random variables of the tiny JAX YOLOv8, the class biases
    spread around 0 so that the scores spread over (0, 1)."""
    jm = jyolo.YOLOv8(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    return random_variables({k: dict(v) for k, v in shapes.items()}, seed)


@pytest.fixture(scope="module")
def tiny():
    variables = _tiny_variables()
    image = np.random.RandomState(4).rand(2, 64, 64, 3)
    return variables, image


def test_head_matches_jax_f64(tiny):
    """``YOLOv8Head`` on the tiny neck's output widths: DFL logits (B, A,
    4, 16) and class logits (B, A, C), f32 on both sides (the reference
    casts them), within f32 rounding of the f64 values."""
    variables = _f64({c: {"head": v["head"]} for c, v in tiny[0].items()})
    rs = np.random.RandomState(5)
    feats = _maps(rs, 2, (8, 4, 2), (32, 64, 128))
    jm = jyolo.YOLOv8Head(4, width=32, dtype=jnp.float64)
    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(lambda v, f: jm.apply(v, f))(
            {c: v["head"] for c, v in variables.items()},
            [jnp.asarray(f) for f in feats]))
    tm = load_from_flax(tyolo.YOLOv8Head((32, 64, 128), 4, width=32).double(),
                        {c: v["head"] for c, v in variables.items()})
    with torch.no_grad():
        got = tm.eval()([_nchw(f) for f in feats])
    for g, r, shape in zip(got, ref, ((2, 84, 4, 16), (2, 84, 4))):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == shape
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)


def _jax_predict(variables, image, dtype, **kw):
    jm = jyolo.YOLOv8(**TINY, dtype=dtype)
    return jax.device_get(jax.jit(lambda v, x: jm.apply(
        v, x, method=jm.predict, **kw))(variables, jnp.asarray(image)))


@pytest.mark.parametrize("score_threshold", [0.01, 0.55])
def test_predict_matches_jax_f64(tiny, score_threshold):
    """``predict`` end to end with f64 compute: the logits, then (from
    their f32 cast) the decode, top-k, class-aware NMS at 0.7 and the
    padding. Boxes and scores within f32 rounding, the labels (and so the
    kept set, -1 padded) equal; at threshold 0.55 part of the candidates
    fall under it and the padding shows."""
    variables, image = _f64(tiny[0]), tiny[1]
    with jax.enable_x64(True):
        ref = _jax_predict(variables, image, jnp.float64,
                           score_threshold=score_threshold)
        dfl, cls = jax.device_get(jax.jit(lambda v, x: jyolo.YOLOv8(
            **TINY, dtype=jnp.float64).apply(v, x))(variables,
                                                    jnp.asarray(image)))
    tm = yolov8_from_flax(tyolo.YOLOv8(**TINY, dtype=torch.float64).double(),
                          variables).eval()
    got = tm.predict(torch.from_numpy(image),
                     score_threshold=score_threshold)
    with torch.no_grad():
        tdfl, tcls = tm(torch.from_numpy(image))
    np.testing.assert_allclose(tdfl.numpy(), dfl, rtol=F32_ROUNDING,
                               atol=1e-30)
    np.testing.assert_allclose(tcls.numpy(), cls, rtol=F32_ROUNDING,
                               atol=1e-30)
    assert got["labels"].shape == (2, 84) and got["boxes"].shape == (2, 84, 4)
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=F32_ROUNDING, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=F32_ROUNDING, atol=1e-30)
    kept = ref["labels"] >= 0
    assert kept.sum(1).min() > 0
    if score_threshold > 0.5:
        assert (~kept).sum(1).min() > 0
        assert (got["boxes"].numpy()[~kept] == 0).all()


def test_predict_logits_match_jax_f32(tiny):
    """f32 compute: the DFL and class logits within 1e-4, and ``predict``'s
    kept labels equal."""
    variables, image = tiny
    image = image.astype(np.float32)
    jm = jyolo.YOLOv8(**TINY)
    dfl, cls = jax.device_get(jax.jit(lambda v, x: jm.apply(v, x))(
        variables, jnp.asarray(image)))
    tm = yolov8_from_flax(tyolo.YOLOv8(**TINY), variables).eval()
    with torch.no_grad():
        tdfl, tcls = tm(torch.from_numpy(image))
    np.testing.assert_allclose(tdfl.numpy(), dfl, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcls.numpy(), cls, rtol=0, atol=1e-4)
    ref = _jax_predict(variables, image, jnp.float32)
    np.testing.assert_array_equal(
        tm.predict(torch.from_numpy(image))["labels"].numpy(), ref["labels"])


def test_yolov8_from_flax_is_a_bijection(tiny):
    """Every flax leaf lands in one port tensor: the counts agree, a conv
    kernel arrives transposed to (O, I, kh, kw) and a leaf left over or
    missing raises."""
    variables = tiny[0]
    tm = yolov8_from_flax(tyolo.YOLOv8(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    k = variables["params"]["backbone"]["stage1"]["in"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        getattr(tm.backbone.stage1, "in").conv.weight.detach().numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        tm.head.cls_out2.bias.detach().numpy(),
        variables["params"]["head"]["cls_out2"]["bias"])
    extra = {c: dict(v) for c, v in variables.items()}
    extra["params"] = dict(extra["params"], stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="no port tensor"):
        yolov8_from_flax(tyolo.YOLOv8(**TINY), extra)
    missing = {c: dict(v) for c, v in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items()
                         if k != "head"}
    with pytest.raises(KeyError, match="missing"):
        yolov8_from_flax(tyolo.YOLOv8(**TINY), missing)


def test_init_weights_follow_the_reference():
    """flax's default initialisers (identity BN, zero biases) but the
    class convs' biases at -4.59, as the reference's ``bias_init``."""
    tm = tyolo.YOLOv8(**TINY).init_weights(torch.Generator().manual_seed(0))
    for i in range(3):
        assert bool((getattr(tm.head, f"cls_out{i}").bias == -4.59).all())
        assert bool((getattr(tm.head, f"reg_out{i}").bias == 0).all())
    bn = tm.backbone.stem.bn
    assert bn.momentum == pytest.approx(0.03) and bn.eps == 1e-3
    assert bool((bn.weight == 1).all()) and bool((bn.running_var == 1).all())


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov8_entry()


def test_entry_builds_on_cpu_when_asked():
    """``yolov8_entry`` builds (no request: the full-width model is for the
    card): YOLOv8-s at 640x640, 80 classes, bf16 parameters and compute,
    channels_last, eval mode, ~11.2M parameters, the class biases at
    -4.59; the image is ``bench.py``'s ``RandomState(0)`` draw."""
    predict, (image,) = yolov8_entry(device="cpu", batch=2)
    model = predict.__self__
    assert not model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.head.cls_out0.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert sum(p.numel() for p in model.parameters()) == 11_166_544
    points, strides = model.grid("cpu")
    assert points.shape == (8400, 2) and points.dtype == torch.float32
    assert float(points.max()) == 636.0 and float(strides.max()) == 32.0
    want = np.random.RandomState(0).rand(2, YOLO_RES, YOLO_RES, 3)
    np.testing.assert_array_equal(image.numpy(), want.astype(np.float32))
    assert torch.equal(build_yolov8("cpu").head.cls_out1.bias,
                       model.head.cls_out1.bias)
