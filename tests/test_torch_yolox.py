"""The port's YOLOX serving path vs the JAX package's, on the CPU.

A tiny YOLOX (width 0.125, depth 0.33, 4 classes, 64x64: A = 84 anchor
points) and its new modules alone: ``PAN`` (the neck with its lateral
reduces, eval and train mode), ``YOLOXHead``, ``decode_yolox`` and
``predict``. The flax variables are numpy-random (kernels at fan-in scale,
BN off identity) and go to the port through ``load_from_flax`` /
``yolox_from_flax``; the JAX side runs jitted, one model ``init`` shape per
file.

Tolerances: with f64 compute, every map of the network within 1e-9 of its
largest value; the head's outputs, cast to f32 on both sides as the
reference casts them, and what follows them (decode, top-k, NMS) within
f32 rounding (rtol 2**-22), the kept sets equal. With f32 compute the
head's outputs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8 import (F32_ROUNDING, F64_RTOL, _assert_close, _f64,
                               _flax_variables, _maps, _nchw, _nhwc)

from minddet_tpu.models.detectors import yolox as jyolox
from minddet_tpu.models.necks import pan as jpan
from minddet_tpu_torch.entry import (YOLO_RES, YOLOX_SERVE_BIAS, build_yolox,
                                     calibrate_yolox, yolox_entry)
from minddet_tpu_torch.models.detectors import yolox as tyolox
from minddet_tpu_torch.models.necks import pan as tpan
from minddet_tpu_torch.utils.convert import load_from_flax, yolox_from_flax

TINY = dict(num_classes=4, image_hw=(64, 64), width_mult=0.125,
            depth_mult=0.33)
NECK_IN = (32, 64, 128)  # the tiny CSPDarknet's (C3, C4, C5) widths
NECK_HW = (8, 4, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pan_matches_jax_f64(train):
    """``PAN`` alone at unequal widths (a crossed wire between P4 / P5 and
    the backbone's maps would change a shape or a value): (N3, N4, N5)
    within 1e-9, and in train mode the running statistics after one
    step."""
    rs = np.random.RandomState(1)
    x = _maps(rs, 2, NECK_HW, NECK_IN)
    jm = jpan.PAN((24, 48, 96), 2, dtype=jnp.float64)
    with jax.enable_x64(True):
        xs = (tuple(jnp.asarray(a) for a in x),)
        variables = _flax_variables(jm, *xs)
        ref, mutated = jax.device_get(jax.jit(lambda v, a: jm.apply(
            v, a, train, mutable=["batch_stats"]))(variables, *xs))
    tm = load_from_flax(tpan.PAN(NECK_IN, (24, 48, 96), 2).double(),
                        variables).train(train)
    with torch.no_grad():
        got = tm([_nchw(a) for a in x])
    for g, r, c in zip(got, ref, (24, 48, 96)):
        assert g.shape[1] == c
        _assert_close(_nhwc(g), r, F64_RTOL)
    if train:
        stats = mutated["batch_stats"]
        for name, bn in (("reduce5", tm.reduce5.bn), ("bu5", tm.bu5.out.bn)):
            s = stats[name]["bn"] if name == "reduce5" else \
                stats[name]["out"]["bn"]
            _assert_close(bn.running_mean.numpy(), s["mean"], F64_RTOL)
            _assert_close(bn.running_var.numpy(), s["var"], F64_RTOL)


def test_decode_yolox_matches_jax():
    """Random offsets, the exp's clip at both ends included, f32 on both
    sides: each corner within f32 rounding of the centre's and the half
    size's magnitudes (the exp may differ by an ulp, and a corner is their
    difference)."""
    rs = np.random.RandomState(2)
    reg = (rs.randn(2, 84, 4) * 3).astype(np.float32)
    reg[0, :3, 2:] = [[-12, 9], [-10, 8], [20, -30]]
    pts, sts = jyolox.yolo_grid((64, 64))
    ref = np.asarray(jyolox.decode_yolox(jnp.asarray(reg),
                                         jnp.asarray(pts)[None],
                                         jnp.asarray(sts)[None]))
    got = tyolox.decode_yolox(torch.from_numpy(reg),
                              torch.from_numpy(pts)[None],
                              torch.from_numpy(sts)[None]).numpy()
    centre = np.abs(ref[..., :2] + ref[..., 2:]) / 2
    half = (ref[..., 2:] - ref[..., :2]) / 2
    scale = np.concatenate([centre + half] * 2, -1)
    assert (np.abs(got - ref) <= F32_ROUNDING * scale).all()
    assert half.max() > 1e4 and half.min() < 1e-3  # both clips reached


def _tiny_shapes():
    jm = jyolox.YOLOX(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    return {k: dict(v) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def tiny():
    variables = random_variables(_tiny_shapes(), 3)
    image = np.random.RandomState(4).rand(2, 64, 64, 3)
    return variables, image


def test_head_matches_jax_f64(tiny):
    """``YOLOXHead`` on the tiny neck's widths: offsets (B, A, 4),
    objectness (B, A) and class logits (B, A, C), f32 on both sides within
    f32 rounding of the f64 values."""
    head = _f64({c: v["head"] for c, v in tiny[0].items()})
    feats = _maps(np.random.RandomState(5), 2, NECK_HW, NECK_IN)
    jm = jyolox.YOLOXHead(4, width=32, dtype=jnp.float64)
    with jax.enable_x64(True):
        ref = jax.device_get(jax.jit(lambda v, f: jm.apply(v, f))(
            head, [jnp.asarray(f) for f in feats]))
    tm = load_from_flax(tyolox.YOLOXHead(NECK_IN, 4, width=32).double(),
                        head)
    with torch.no_grad():
        got = tm.eval()([_nchw(f) for f in feats])
    for g, r, shape in zip(got, ref, ((2, 84, 4), (2, 84), (2, 84, 4))):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == shape
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)


def _jax_outputs(variables, image, dtype, **kw):
    """The JAX model's head outputs and ``predict`` at each threshold of
    ``kw["thresholds"]``, one jitted call."""
    jm = jyolox.YOLOX(**TINY, dtype=dtype)

    def run(v, x):
        return jm.apply(v, x), [jm.apply(v, x, method=jm.predict,
                                         score_threshold=t)
                                for t in kw["thresholds"]]

    return jax.device_get(jax.jit(run)(variables, jnp.asarray(image)))


THRESHOLDS = (0.01, 0.245)  # the tiny model's scores lie in 0.237-0.265


def test_predict_matches_jax_f64(tiny):
    """``predict`` end to end with f64 compute at score thresholds 0.01 and
    0.245: the head's outputs, then (from their f32 cast) the decode, the
    scores sigmoid(cls) sigmoid(obj), top-k, class-aware NMS at 0.65 and
    the padding. Boxes and scores within f32 rounding, the labels (and so
    the kept set, -1 padded) equal; at 0.245 part of the candidates fall
    under the threshold and the padding shows."""
    variables, image = _f64(tiny[0]), tiny[1]
    with jax.enable_x64(True):
        outs, preds = _jax_outputs(variables, image, jnp.float64,
                                   thresholds=THRESHOLDS)
    tm = yolox_from_flax(tyolox.YOLOX(**TINY, dtype=torch.float64).double(),
                         variables).eval()
    with torch.no_grad():
        got_outs = tm(torch.from_numpy(image))
    for g, r in zip(got_outs, outs):
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)
    for t, ref in zip(THRESHOLDS, preds):
        got = tm.predict(torch.from_numpy(image), score_threshold=t)
        assert got["labels"].shape == (2, 84)
        np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
        np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                                   rtol=F32_ROUNDING, atol=1e-4)
        np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                                   rtol=F32_ROUNDING, atol=1e-30)
        kept = ref["labels"] >= 0
        assert kept.sum(1).min() > 0
        if t > 0.1:
            assert (~kept).sum(1).min() > 0
            assert (got["boxes"].numpy()[~kept] == 0).all()


def test_head_outputs_match_jax_f32(tiny):
    """f32 compute: the offsets, objectness and class logits within 1e-4,
    and ``predict``'s kept labels equal."""
    variables, image = tiny
    image = image.astype(np.float32)
    outs, preds = _jax_outputs(variables, image, jnp.float32,
                               thresholds=(0.01,))
    tm = yolox_from_flax(tyolox.YOLOX(**TINY), variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(image))
    for g, r in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        tm.predict(torch.from_numpy(image))["labels"].numpy(),
        preds[0]["labels"])


def test_yolox_from_flax_is_a_bijection(tiny):
    """Every flax leaf lands in one port tensor: the counts agree, the
    neck's lateral reduce and the head's objectness conv arrive where their
    scopes say, a leaf left over raises."""
    variables = tiny[0]
    tm = yolox_from_flax(tyolox.YOLOX(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    k = variables["params"]["neck"]["reduce5"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        tm.neck.reduce5.conv.weight.detach().numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        tm.head.obj_out1.bias.detach().numpy(),
        variables["params"]["head"]["obj_out1"]["bias"])
    extra = {c: dict(v) for c, v in variables.items()}
    extra["params"] = dict(extra["params"], stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="no port tensor"):
        yolox_from_flax(tyolox.YOLOX(**TINY), extra)


def test_init_weights_follow_the_reference():
    """flax's default initialisers (identity BN, zero biases) but the class
    and objectness convs' biases at -4.59, as the reference's
    ``bias_init``."""
    tm = tyolox.YOLOX(**TINY).init_weights(torch.Generator().manual_seed(0))
    for i in range(3):
        for name in (f"cls_out{i}", f"obj_out{i}"):
            assert bool((getattr(tm.head, name).bias == -4.59).all())
        assert bool((getattr(tm.head, f"reg_out{i}").bias == 0).all())
    bn = tm.neck.reduce5.bn
    assert bn.momentum == pytest.approx(0.03) and bn.eps == 1e-3
    assert bool((bn.weight == 1).all()) and bool((bn.running_var == 1).all())


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolox_entry()


def test_entry_builds_on_cpu_when_asked():
    """``yolox_entry`` builds (no request: the full-width model is for the
    card): YOLOX-s at 640x640, 80 classes, bf16 parameters and compute,
    channels_last, eval mode, ~8.97M parameters, the six score biases
    calibrated to 0 (``build_yolox`` keeps the reference's -4.59); the
    image is ``yolov8_entry``'s."""
    predict, (image,) = yolox_entry(device="cpu", batch=2)
    model = predict.__self__
    assert not model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.head.cls_out0.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert sum(p.numel() for p in model.parameters()) == 8_965_663
    for i in range(3):
        for name in (f"cls_out{i}", f"obj_out{i}"):
            assert bool((getattr(model.head, name).bias
                         == YOLOX_SERVE_BIAS).all())
    points, strides = model.grid("cpu")
    assert points.shape == (8400, 2) and points.dtype == torch.float32
    want = np.random.RandomState(0).rand(2, YOLO_RES, YOLO_RES, 3)
    np.testing.assert_array_equal(image.numpy(), want.astype(np.float32))
    raw = build_yolox("cpu")
    assert bool((raw.head.obj_out1.bias == -4.59).all())
    assert torch.equal(calibrate_yolox(raw).head.cls_out1.bias,
                       model.head.cls_out1.bias)
