"""The port's YOLOv5 serving path vs the JAX package's, on the CPU.

A tiny YOLOv5 (width 0.125, depth 0.33, 4 classes, 64x64: 84 cells x 3
anchors) through ``yolov5_from_flax``: the head outputs (B, H, W, na, 5 +
C) per level (the conv's channel a (5 + C) + k is anchor a's entry k),
``_decode_level`` in both flavours ("sigmoid2", YOLOv5's and YOLOv7's, and
"exp", YOLOv4's, its clip at +-8 reached) and ``predict``. The flax
variables are numpy-random (kernels at fan-in scale, BN off identity); the
JAX side runs jitted, one model ``init`` shape per file. The neck, ``PAN``,
is held alone in ``test_torch_yolox.py``.

Tolerances as ``test_torch_yolov8.py``'s: with f64 compute the head's
outputs, cast to f32 on both sides, and what follows them within f32
rounding (rtol 2**-22), the kept sets equal; with f32 compute the head's
outputs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointpillars import random_variables
from test_torch_yolov8 import F32_ROUNDING, _f64

from minddet_tpu.models.detectors import yolov5 as jyolov5
from minddet_tpu_torch.entry import YOLO_RES, build_yolov5, yolov5_entry
from minddet_tpu_torch.models.detectors import yolov5 as tyolov5
from minddet_tpu_torch.utils.convert import yolov5_from_flax

TINY = dict(num_classes=4, image_hw=(64, 64), width_mult=0.125,
            depth_mult=0.33)
LEVEL_HW = (8, 4, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_anchors_and_constants_match_the_reference():
    assert tyolov5.YOLOV5_ANCHORS == jyolov5.YOLOV5_ANCHORS
    assert tyolov5.AnchorYOLO.OBJ_BALANCE == jyolov5._AnchorYOLO.OBJ_BALANCE
    assert tyolov5.AnchorYOLO.STRIDES == jyolov5._AnchorYOLO.STRIDES


@pytest.mark.parametrize("flavor", ["sigmoid2", "exp"])
def test_decode_level_matches_jax(flavor):
    """Random head outputs of each level (f32, large enough that the exp's
    clip at +-8 is reached): boxes, objectness and class logits; boxes
    within f32 rounding of the centre's and the half size's magnitudes."""
    rs = np.random.RandomState(["sigmoid2", "exp"].index(flavor))
    jm = jyolov5.YOLOv5(**TINY, decode_flavor=flavor)
    tm = tyolov5.YOLOv5(**TINY, decode_flavor=flavor)
    for li, hw in enumerate(LEVEL_HW):
        out = (rs.randn(2, hw, hw, 3, 9) * 4).astype(np.float32)
        ref = jax.device_get(jm._decode_level(
            jnp.asarray(out), jm.anchors[li], jm.STRIDES[li]))
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
    if flavor == "exp":
        assert half.max() > 2000  # exp(8) x the largest anchor's half


def _tiny_shapes():
    jm = jyolov5.YOLOv5(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    return {k: dict(v) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def tiny():
    variables = random_variables(_tiny_shapes(), 6)
    image = np.random.RandomState(7).rand(2, 64, 64, 3)
    return variables, image


THRESHOLDS = (0.05, 0.25)  # the tiny model's scores lie around 0.25


def _jax_outputs(variables, image, dtype, thresholds):
    jm = jyolov5.YOLOv5(**TINY, dtype=dtype)

    def run(v, x):
        return jm.apply(v, x), [jm.apply(v, x, method=jm.predict,
                                         score_threshold=t)
                                for t in thresholds]

    return jax.device_get(jax.jit(run)(variables, jnp.asarray(image)))


def test_predict_matches_jax_f64(tiny):
    """With f64 compute: each level's head output (B, H, W, 3, 9), f32 on
    both sides within f32 rounding; ``predict`` (sigmoid(cls)
    sigmoid(obj), top-k, class-aware NMS at 0.45, the padding) at score
    thresholds 0.05 and 0.25: boxes and scores within f32 rounding, the
    labels (and so the kept set, -1 padded) equal; at 0.25 part of the
    candidates fall under the threshold."""
    variables, image = _f64(tiny[0]), tiny[1]
    with jax.enable_x64(True):
        outs, preds = _jax_outputs(variables, image, jnp.float64, THRESHOLDS)
    tm = yolov5_from_flax(tyolov5.YOLOv5(**TINY, dtype=torch.float64)
                          .double(), variables).eval()
    with torch.no_grad():
        got_outs = tm(torch.from_numpy(image))
    for g, r, hw in zip(got_outs, outs, LEVEL_HW):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == (2, hw, hw, 3, 9)
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)
    for t, ref in zip(THRESHOLDS, preds):
        got = tm.predict(torch.from_numpy(image), score_threshold=t)
        assert got["labels"].shape == (2, 100)
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
    """f32 compute: every level's head output within 1e-4, and
    ``predict``'s kept labels equal."""
    variables, image = tiny
    image = image.astype(np.float32)
    outs, preds = _jax_outputs(variables, image, jnp.float32, (0.05,))
    tm = yolov5_from_flax(tyolov5.YOLOv5(**TINY), variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(image))
    for g, r in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        tm.predict(torch.from_numpy(image))["labels"].numpy(),
        preds[0]["labels"])


def test_yolov5_from_flax_is_a_bijection(tiny):
    """Every flax leaf lands in one port tensor: the counts agree, the 1x1
    ``head{i}`` convs arrive transposed, a leaf missing raises."""
    variables = tiny[0]
    tm = yolov5_from_flax(tyolov5.YOLOv5(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    k = variables["params"]["head2"]["kernel"]
    np.testing.assert_array_equal(tm.head2.weight.detach().numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    missing = {c: dict(v) for c, v in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items()
                         if k != "head1"}
    with pytest.raises(KeyError, match="missing"):
        yolov5_from_flax(tyolov5.YOLOv5(**TINY), missing)


def test_decode_flavor_is_checked():
    with pytest.raises(ValueError, match="decode_flavor"):
        tyolov5.YOLOv5(**TINY, decode_flavor="linear")


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov5_entry()


def test_entry_builds_on_cpu_when_asked():
    """``yolov5_entry`` builds (no request: the full-width model is for the
    card): YOLOv5-s at 640x640, 80 classes, bf16 parameters and compute,
    channels_last, eval mode, ~7.23M parameters, the heads' biases at 0 (no
    calibration); the image is ``yolov8_entry``'s."""
    predict, (image,) = yolov5_entry(device="cpu", batch=2)
    model = predict.__self__
    assert not model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.head0.weight.is_contiguous(memory_format=torch.channels_last)
    assert sum(p.numel() for p in model.parameters()) == 7_232_797
    assert model.head0.weight.shape[0] == 3 * 85
    for i in range(3):
        assert bool((getattr(model, f"head{i}").bias == 0).all())
    (wh,) = model.anchor_wh[2]("cpu")
    assert wh.dtype == torch.float32 and wh.tolist() == [
        [116, 90], [156, 198], [373, 326]]
    want = np.random.RandomState(0).rand(2, YOLO_RES, YOLO_RES, 3)
    np.testing.assert_array_equal(image.numpy(), want.astype(np.float32))
    assert torch.equal(build_yolov5("cpu").head1.weight, model.head1.weight)
