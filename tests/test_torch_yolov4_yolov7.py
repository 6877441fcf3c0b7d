"""The port's YOLOv4 and YOLOv7 vs the JAX package's, on the CPU.

Each module alone at f64 compute, eval mode (train mode for ``MishConv``,
its BN statistics' update included): ``mish``, ``MishConv``,
``_CSP53Stage`` (one block at the whole width, and several at half of it),
``CSPDarknet53``, ``ELANBlock``, ``MPDown`` (at its input's width and
wider) and ``ELANNet``, every output map within 1e-9 of its largest value.
Then the
tiny YOLOv4 and YOLOv7 (width 0.125, 4 classes, 64x64) through
``yolov4_from_flax`` / ``yolov7_from_flax``: the head outputs, cast to f32
on both sides as the reference casts them, within f32 rounding (rtol
2**-22), ``predict`` slot by slot; one train step with f64 compute over f32
parameters and the configs' SGD (YOLOv4: momentum 0.949 without Nesterov;
YOLOv7: 0.937 with it; decay 5e-4) at a constant lr 0.01: the loss parts
1e-6, every gradient 1e-5 of its largest element, the parameters after the
step and the BN statistics 1e-6 (``test_torch_yolox_train.py``'s checks);
the converters, the constants and the four entries. The JAX side runs
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
from test_torch_yolox_train import (_step_batch, check_loss_parts,
                                    check_train_step, step_both)

from minddet_tpu.models.backbones import csp_darknet as jcsp
from minddet_tpu.models.backbones import elan as jelan
from minddet_tpu.models.detectors import yolov4 as jyolov4
from minddet_tpu.models.detectors import yolov7 as jyolov7
from minddet_tpu_torch import entry
from minddet_tpu_torch.models.backbones import csp_darknet as tcsp
from minddet_tpu_torch.models.backbones import elan as telan
from minddet_tpu_torch.models.detectors import yolov4 as tyolov4
from minddet_tpu_torch.models.detectors import yolov7 as tyolov7
from minddet_tpu_torch.train.synthetic import synthetic_detection_batch
from minddet_tpu_torch.utils.convert import (load_from_flax, yolov4_from_flax,
                                             yolov7_from_flax)

TINY = dict(num_classes=4, image_hw=(64, 64), width_mult=0.125)
LEVEL_HW = (8, 4, 2)
PARTS = ("box_loss", "obj_loss", "cls_loss")
# per model: the JAX class, the port's, its converter, its config's momentum
# and Nesterov
MODELS = {
    "yolov4": (jyolov4.YOLOv4, tyolov4.YOLOv4, yolov4_from_flax,
               entry.YOLOV4_MOMENTUM, False),
    "yolov7": (jyolov7.YOLOv7, tyolov7.YOLOv7, yolov7_from_flax,
               entry.YOLOV7_MOMENTUM, True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (JAX module, port module, input maps (H = W, C)): each at f64 compute
MODULES = {
    "mish_conv_s2": (lambda: jcsp.MishConv(24, 3, 2, dtype=jnp.float64),
                     lambda: tcsp.MishConv(16, 24, 3, 2), [(16, 16)]),
    "csp53_stage_one_block": (
        lambda: jcsp._CSP53Stage(16, 1, dtype=jnp.float64),
        lambda: tcsp.CSP53Stage(16, 16, 1), [(12, 16)]),
    "csp53_stage_three_blocks": (
        lambda: jcsp._CSP53Stage(32, 3, dtype=jnp.float64),
        lambda: tcsp.CSP53Stage(24, 32, 3), [(12, 24)]),
    "csp_darknet53": (lambda: jcsp.CSPDarknet53(0.125, dtype=jnp.float64),
                      lambda: tcsp.CSPDarknet53(0.125), [(64, 3)]),
    "elan_block": (lambda: jelan.ELANBlock(32, 16, dtype=jnp.float64),
                   lambda: telan.ELANBlock(24, 32, 16), [(12, 24)]),
    "elan_block_narrow_hidden": (
        lambda: jelan.ELANBlock(24, 6, dtype=jnp.float64),
        lambda: telan.ELANBlock(16, 24, 6), [(9, 16)]),
    "mp_down": (lambda: jelan.MPDown(32, dtype=jnp.float64),
                lambda: telan.MPDown(16, 32), [(12, 16)]),
    "mp_down_widens": (lambda: jelan.MPDown(48, dtype=jnp.float64),
                       lambda: telan.MPDown(16, 48), [(8, 16)]),
    "elan_net": (lambda: jelan.ELANNet(0.125, dtype=jnp.float64),
                 lambda: telan.ELANNet(0.125), [(64, 3)]),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_f64(name):
    """Eval mode, f64 compute: every output map within 1e-9 of its
    largest value; the backbones' ``out_channels`` are their maps'."""
    make_j, make_t, spec = MODULES[name]
    rs = np.random.RandomState(sorted(MODULES).index(name))
    (x,) = _maps(rs, 2, *zip(*spec))
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


def test_mish_matches_flax_f64():
    """``mish`` and its gradient against the reference's x tanh(softplus
    (x)) on [-40, 40], past torch's softplus threshold of 20: 1e-12
    relative."""
    x = np.linspace(-40, 40, 4001)
    with jax.enable_x64(True):
        want, grad = jax.vmap(jax.value_and_grad(jcsp.mish))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = tcsp.mish(t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(t.grad.numpy(), grad, rtol=1e-12, atol=1e-15)


def test_mish_conv_train_mode_matches_jax_f64():
    """Train mode: the output from the batch's statistics, and the running
    statistics after one step of flax's momentum 0.97 (torch's 0.03, eps
    1e-3), within 1e-9."""
    x = np.random.RandomState(7).randn(2, 10, 10, 8) * 2 + 0.5
    jm = jcsp.MishConv(12, 3, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x))
        ref, mutated = jax.jit(lambda v, a: jm.apply(
            v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        ref, stats = jax.device_get((ref, mutated["batch_stats"]["bn"]))
    tm = load_from_flax(tcsp.MishConv(8, 12, 3).double(), variables)
    assert (tm.bn.momentum, tm.bn.eps) == (0.03, 1e-3)
    with torch.no_grad():
        got = tm.train()(_nchw(x))
    _assert_close(_nhwc(got), ref, F64_RTOL)
    _assert_close(tm.bn.running_mean.numpy(), stats["mean"], F64_RTOL)
    _assert_close(tm.bn.running_var.numpy(), stats["var"], F64_RTOL)


def test_anchors_and_defaults_match_the_reference():
    assert tyolov4.YOLOV4_ANCHORS == jyolov4.YOLOV4_ANCHORS
    assert tyolov7.YOLOV7_ANCHORS == jyolov7.YOLOV7_ANCHORS
    for name, (jcls, tcls, _, _, _) in MODELS.items():
        jm, tm = jcls(), tcls()
        assert (tm.anchors, tm.decode_flavor, tm.width_mult) == (
            jm.anchors, jm.decode_flavor, jm.width_mult), name
        assert tm.neck_channels() == jm._neck_channels(), name


def _tiny_shapes(jcls):
    jm = jcls(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    return {k: dict(v) for k, v in shapes.items()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def served(request):
    """One model's f64 comparison, the JAX side jitted once: the head
    outputs and ``predict`` at score threshold 0.05 of both sides."""
    jcls, tcls, from_flax, _, _ = MODELS[request.param]
    variables = _f64(random_variables(_tiny_shapes(jcls), 9))
    image = np.random.RandomState(10).rand(2, 64, 64, 3)
    jm = jcls(**TINY, dtype=jnp.float64)
    with jax.enable_x64(True):
        outs, pred = jax.device_get(jax.jit(lambda v, x: (
            jm.apply(v, x), jm.apply(v, x, method=jm.predict)))(
                variables, jnp.asarray(image)))
    tm = from_flax(tcls(**TINY, dtype=torch.float64).double(),
                   variables).eval()
    with torch.no_grad():
        got_outs = tm(torch.from_numpy(image))
    got = tm.predict(torch.from_numpy(image))
    return dict(outs=outs, pred=pred, got_outs=got_outs, got=got)


def test_head_outputs_match_jax_f64(served):
    """Each level's (B, H, W, 3, 9) f32 on both sides within f32
    rounding."""
    for g, r, hw in zip(served["got_outs"], served["outs"], LEVEL_HW):
        assert g.dtype == torch.float32 and r.dtype == np.float32
        assert tuple(g.shape) == r.shape == (2, hw, hw, 3, 9)
        np.testing.assert_allclose(g.numpy(), r, rtol=F32_ROUNDING,
                                   atol=1e-30)


def test_predict_matches_jax_f64(served):
    """``predict`` (top 1000, class-aware NMS 0.45 over 0.05): the labels,
    and so the kept set, equal slot by slot, boxes and scores within f32
    rounding."""
    got, ref = served["got"], served["pred"]
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               rtol=F32_ROUNDING, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               rtol=F32_ROUNDING, atol=1e-30)
    assert (ref["labels"] >= 0).sum(1).min() > 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_flax_is_a_bijection(name):
    """Every flax leaf lands in one port tensor; a leaf missing raises."""
    jcls, tcls, from_flax, _, _ = MODELS[name]
    variables = random_variables(_tiny_shapes(jcls), 3)
    tm = from_flax(tcls(**TINY), variables)
    leaves = jax.tree_util.tree_leaves(variables)
    state = {k: v for k, v in tm.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert len(state) == len(leaves)
    assert sum(v.numel() for v in state.values()) == sum(
        np.size(a) for a in leaves)
    missing = {c: dict(v) for c, v in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items()
                         if k != "backbone"}
    with pytest.raises(KeyError, match="missing"):
        from_flax(tcls(**TINY), missing)


@pytest.fixture(scope="module", params=sorted(MODELS))
def trained(request):
    jcls, tcls, from_flax, momentum, nesterov = MODELS[request.param]
    variables = random_variables(_tiny_shapes(jcls), seed=11)
    return step_both(jcls(**TINY, dtype=jnp.float64),
                     tcls(**TINY, dtype=torch.float64), from_flax, variables,
                     _step_batch(), momentum, nesterov), request.param


def test_loss_parts_match_jax_f64(trained):
    check_loss_parts(trained[0], PARTS)


def test_train_step_matches_jax_f64(trained):
    s, name = trained
    _, tcls, from_flax, _, _ = MODELS[name]
    check_train_step(s, tcls(**TINY), from_flax)


ENTRIES = ("yolov4_entry", "yolov7_entry", "yolov4_train_entry",
           "yolov7_train_entry")


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_without_gpu_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(entry, name)()


@pytest.mark.parametrize("name,res", [("yolov4", 512), ("yolov7", 640)])
def test_entry_builds_on_cpu_when_asked(name, res):
    """The serving entry builds (no request: the full-width model is for
    the card): the config's model at its resolution, 80 classes, bf16
    parameters and compute, channels_last, eval mode, as many parameters
    as the reference's model of the config (YOLOv4 at width 1.0, YOLOv7 at
    0.5), the heads' biases at 0; the image is the config's size of
    ``yolov8_entry``'s draw. The train
    entry: f32 parameters, bf16 compute, train mode, the config's guarded
    SGD (no clip) with lr 0 at count 0 of its warm-up cosine, the
    reference's batch."""
    predict, (image,) = getattr(entry, f"{name}_entry")(device="cpu",
                                                        batch=2)
    model = predict.__self__
    assert not model.training and model.dtype == torch.bfloat16
    assert model.image_hw == (res, res)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.head0.weight.is_contiguous(memory_format=torch.channels_last)
    jcls = MODELS[name][0]
    width = getattr(entry, f"{name.upper()}_WIDTH")
    shapes = jax.eval_shape(lambda: jcls(width_mult=width).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(shapes))
    for i in range(3):
        assert bool((getattr(model, f"head{i}").bias == 0).all())
    (wh,) = model.anchor_wh[2]("cpu")
    assert wh.dtype == torch.float32 and wh.tolist() == [
        [142, 110], [192, 243], [459, 401]]
    want = np.random.RandomState(0).rand(2, res, res, 3)
    np.testing.assert_array_equal(image.numpy(), want.astype(np.float32))
    del predict, model

    step_fn, (state, batch) = getattr(entry, f"{name}_train_entry")(
        device="cpu", batch=2)
    model, tx = state.model, state.tx
    assert callable(step_fn) and model.training
    assert model.dtype == torch.bfloat16 and model.image_hw == (res, res)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    momentum = getattr(entry, f"{name.upper()}_MOMENTUM")
    assert (tx.momentum, tx.nesterov, tx.weight_decay, tx.clip_global_norm,
            tx.nan_guard) == (momentum, name == "yolov7", 5e-4, None, True)
    assert float(tx.learning_rate(torch.tensor(0))) == 0.0
    want = synthetic_detection_batch(2, (res, res), 80)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
