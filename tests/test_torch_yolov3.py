"""The port's YOLOv3 serving path vs the JAX package's, on the CPU.

Each module alone at f64 compute: ``_DarkConv`` (eval mode at stride 2,
and train mode with flax's BN momentum 0.9 and eps 1e-5, the statistics'
update included), ``_Residual`` and ``Darknet53``, every output map within
1e-9 of its largest value. ``_decode_level`` at each level (the exp's clip
at +-8 reached). Then YOLOv3 itself at 64x64, batch 1, 4 classes (Darknet53
has no width to cut: the full-width network on a small image) through
``yolov3_from_flax``: the three levels' head outputs (stride 32, 16, 8),
cast to f32 on both sides as the reference casts them, within f32 rounding
(rtol 2**-22), and ``predict`` (top 1000, class-aware NMS 0.45 over 0.05)
slot by slot. The JAX side runs jitted, one compile of the whole model per
file; the flax variables are numpy-random (kernels at fan-in scale, BN off
identity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8 import (F32_ROUNDING, F64_RTOL, _assert_close, _f64,
                               _flax_variables, _maps, _nchw, _nhwc)

from minddet_tpu.models.detectors import yolov3 as jyolov3
from minddet_tpu_torch import entry
from minddet_tpu_torch.models.detectors import yolov3 as tyolov3
from minddet_tpu_torch.utils.convert import load_from_flax, yolov3_from_flax

TINY = dict(num_classes=4, image_hw=(64, 64))
LEVEL_HW = (2, 4, 8)  # strides 32, 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (JAX module, port module, input map (H = W, C), batch): f64 compute
MODULES = {
    "dark_conv_s2": (lambda: jyolov3._DarkConv(24, 3, 2, dtype=jnp.float64),
                     lambda: tyolov3.DarkConv(16, 24, 3, 2), (16, 16), 2),
    "dark_conv_1x1": (lambda: jyolov3._DarkConv(8, 1, dtype=jnp.float64),
                      lambda: tyolov3.DarkConv(16, 8, 1), (9, 16), 2),
    "dark_residual": (lambda: jyolov3._Residual(32, dtype=jnp.float64),
                      lambda: tyolov3.DarkResidual(32), (12, 32), 2),
    "darknet53": (lambda: jyolov3.Darknet53(dtype=jnp.float64),
                  lambda: tyolov3.Darknet53(), (64, 3), 1),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_f64(name):
    """Eval mode, f64 compute: every output map within 1e-9 of its
    largest value; Darknet53's ``out_channels`` are its maps'."""
    make_j, make_t, (hw, c), batch = MODULES[name]
    rs = np.random.RandomState(sorted(MODULES).index(name))
    (x,) = _maps(rs, batch, (hw,), (c,))
    jm = make_j()
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref = jax.device_get(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = load_from_flax(make_t().double(), variables).eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        assert g.shape == _nchw(r).shape
        _assert_close(_nhwc(g), r, F64_RTOL)
    if hasattr(tm, "out_channels"):
        assert tm.out_channels == tuple(r.shape[-1] for r in refs)


def test_dark_conv_train_mode_matches_jax_f64():
    """Train mode: the output from the batch's statistics (leaky ReLU 0.1
    on both signs), and the running statistics after one step of flax's
    momentum 0.9 (torch's 0.1, eps 1e-5), within 1e-9."""
    x = np.random.RandomState(7).randn(2, 10, 10, 8) * 2 + 0.5
    jm = jyolov3._DarkConv(12, 3, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref, mutated = jax.jit(lambda v, a: jm.apply(
            v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        ref, stats = jax.device_get((ref, mutated["batch_stats"]["bn"]))
    tm = load_from_flax(tyolov3.DarkConv(8, 12, 3).double(), variables)
    assert (tm.bn.momentum, tm.bn.eps) == (0.1, 1e-5)
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    _assert_close(_nhwc(got), ref, F64_RTOL)
    _assert_close(tm.bn.running_mean.numpy(), stats["mean"], F64_RTOL)
    _assert_close(tm.bn.running_var.numpy(), stats["var"], F64_RTOL)
    assert (ref < 0).any() and (ref > 0).any()


def test_anchors_and_constants_match_the_reference():
    assert tyolov3.YOLOV3_ANCHORS == jyolov3.YOLOV3_ANCHORS
    tm, jm = tyolov3.YOLOv3(), jyolov3.YOLOv3()
    assert (tm.num_classes, tm.image_hw, tyolov3.IGNORE_IOU) == (
        jm.num_classes, jm.image_hw, jm.ignore_iou)


def test_decode_level_matches_jax():
    """Random f32 head outputs of each level (large enough that the exp's
    clip at +-8 is reached): objectness and class logits exactly, boxes
    within f32 rounding of the centre's and the half size's magnitudes."""
    rs = np.random.RandomState(3)
    jm, tm = jyolov3.YOLOv3(**TINY), tyolov3.YOLOv3(**TINY)
    half_max = 0.0
    for li, (hw, stride) in enumerate(zip(LEVEL_HW, tyolov3.STRIDES)):
        out = (rs.randn(2, hw, hw, 3, 9) * 4).astype(np.float32)
        ref = jax.device_get(jm._decode_level(
            jnp.asarray(out), jyolov3.YOLOV3_ANCHORS[li], stride))
        got = tm.decode_level(torch.from_numpy(out), li)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
        box, want = got[0].numpy(), ref[0]
        centre = np.abs(want[..., :2] + want[..., 2:]) / 2
        half = (want[..., 2:] - want[..., :2]) / 2
        scale = np.concatenate([centre + half] * 2, -1)
        assert (np.abs(box - want) <= F32_ROUNDING * scale).all(), li
        half_max = max(half_max, float(half.max()))
    assert half_max > 50000  # exp(8) x the largest anchor's half


def _shapes():
    jm = jyolov3.YOLOv3(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    return {k: dict(v) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def variables():
    return random_variables(_shapes(), 9)


@pytest.fixture(scope="module")
def served(variables):
    """The f64 comparison, the JAX side jitted once: the head outputs and
    ``predict`` at score threshold 0.05 of both sides."""
    variables = _f64(variables)
    image = np.random.RandomState(10).rand(1, 64, 64, 3)
    jm = jyolov3.YOLOv3(**TINY, dtype=jnp.float64)
    with jax.enable_x64(True):
        outs, pred = jax.device_get(jax.jit(lambda v, x: (
            jm.apply(v, x), jm.apply(v, x, method=jm.predict)))(
                variables, jnp.asarray(image)))
    tm = yolov3_from_flax(tyolov3.YOLOv3(**TINY, dtype=torch.float64)
                          .double(), variables).eval()
    with torch.no_grad():
        got_outs = tm(torch.from_numpy(image))
    got = tm.predict(torch.from_numpy(image))
    return dict(outs=outs, pred=pred, got_outs=got_outs, got=got)


def test_head_outputs_match_jax_f64(served):
    """Each level (stride 32, 16, 8) (1, H, W, 3, 9), f32 on both sides,
    within f32 rounding."""
    for g, r, hw in zip(served["got_outs"], served["outs"], LEVEL_HW):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == (1, hw, hw, 3, 9)
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)


def test_predict_matches_jax_f64(served):
    """``predict``: the labels, and so the kept set (-1 padded), equal slot
    by slot, boxes and scores within f32 rounding."""
    got, ref = served["got"], served["pred"]
    assert got["labels"].shape == (1, 100)
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=F32_ROUNDING, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=F32_ROUNDING, atol=1e-30)
    assert (ref["labels"] >= 0).sum() > 0


def test_yolov3_from_flax_is_a_bijection(variables):
    """Every flax leaf lands in one port tensor: the counts agree, the
    biased 1x1 ``h3_out`` arrives transposed, a leaf missing raises."""
    tm = yolov3_from_flax(tyolov3.YOLOv3(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    k = variables["params"]["h3_out"]["kernel"]
    np.testing.assert_array_equal(tm.h3_out.weight.detach().numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    missing = {c: dict(v) for c, v in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items()
                         if k != "route4"}
    with pytest.raises(KeyError, match="missing"):
        yolov3_from_flax(tyolov3.YOLOv3(**TINY), missing)


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.yolov3_entry()


def test_entry_builds_on_cpu_when_asked():
    """``yolov3_entry`` builds (no request: the full-size model is for the
    card): YOLOv3 at 416x416, 80 classes, bf16 parameters and compute,
    channels_last, eval mode, as many parameters as the reference's, the
    heads' biases at 0 (no calibration), the anchors f32; the image is the
    config's size of ``yolov8_entry``'s draw."""
    predict, (image,) = entry.yolov3_entry(device="cpu", batch=2)
    model = predict.__self__
    assert not model.training and model.dtype == torch.bfloat16
    assert model.image_hw == (416, 416)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.h3_out.weight.is_contiguous(
        memory_format=torch.channels_last)
    shapes = jax.eval_shape(lambda: jyolov3.YOLOv3().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(shapes))
    for name in ("h5_out", "h4_out", "h3_out"):
        assert getattr(model, name).weight.shape[0] == 3 * 85
        assert bool((getattr(model, name).bias == 0).all())
    (wh,) = model.all_anchor_wh("cpu")
    assert wh.dtype == torch.float32
    assert wh.tolist() == [list(a) for lv in jyolov3.YOLOV3_ANCHORS
                           for a in lv]
    want = np.random.RandomState(0).rand(2, 416, 416, 3)
    np.testing.assert_array_equal(image.numpy(), want.astype(np.float32))
