"""DCN at widths that take the flat sampler, up to CenterNet-R18 with DCN
in all four backbone stages, port vs JAX package on the CPU.

- ``ModulatedDeformConv`` with the reference's options (kernel size 3 and
  1, stride 1 and 2, padding 0 and 1, with and without bias) at Cin 64
  (flat sampler) and 128 (tap-grouped), weights carried across by
  ``load_from_flax``, f32 at atol/rtol 1e-4.
- The bias is added to the f32 accumulator and rounded once, in bf16 as
  in the reference.
- ``ResNet(18, dcn_stages=(True,) * 4)`` on a 64x64 image (stage 1 is
  16x16x64): the eval forward, the train-mode forward with the BN
  running-statistic updates, and the vector-Jacobian product of the four
  outputs, in f64 compute so that no ReLU or floor kink decides the
  tolerance.
- The whole CenterNet with that backbone (the JAX side is a subclass of
  the reference's ``CenterNet`` that overrides ``setup`` only; the port
  assigns ``model.backbone``): predict, one train step in f64 compute, and
  the stage-1 offset convs' gradient at init.
- The carrier is a bijection on this model's variables; the two entry
  points build and run on the CPU when asked, and raise without a GPU.

Inputs and weights are made with numpy from a seed (offset convs random,
so that samples leave the integer grid, except where the flax init is the
point). Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.core.optim import adamw as jax_adamw
from minddet_tpu.models.backbones.resnet import ResNet as JaxResNet
from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu.models.heads.centernet_head import \
    CenterNetHead as JaxCenterNetHead
from minddet_tpu.models.layers import ModulatedDeformConv as JaxDCN
from minddet_tpu.models.necks.ct_deconv import \
    CenterNetDeconvNeck as JaxDeconvNeck
from minddet_tpu.ops.dcn import deform_conv2d as jax_dcn
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch.core.optim import adamw
from minddet_tpu_torch.entry import (centernet_dcn4_entry,
                                     centernet_dcn4_train_entry,
                                     synthetic_boxes)
from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.layers import ModulatedDeformConv
from minddet_tpu_torch.ops.dcn import deform_conv2d, dcn_sampling_grid_shapes
from minddet_tpu_torch.ops.targets import centernet_targets_batch
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.utils.convert import (centernet_from_flax,
                                             load_from_flax)

DCN4 = (True,) * 4
LR, CLIP = 5e-4, 35.0


class JaxCenterNetDcn4(JaxCenterNet):
    """The reference's CenterNet with its registered ResNet at
    ``dcn_stages=(True,) * 4``; loss, loss_from_gt and predict inherited."""

    def setup(self):
        self.backbone = JaxResNet(depth=self.depth, dcn_stages=DCN4,
                                  dtype=self.dtype)
        self.neck = JaxDeconvNeck(dtype=self.dtype)
        self.head = JaxCenterNetHead(num_classes=self.num_classes,
                                     head_conv=self.head_conv,
                                     reg_offset=self.reg_offset,
                                     dtype=self.dtype)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _randomize(variables, seed):
    """Random offset/mask convs (std 0.25 / sqrt(fan_in), bias std 0.1), BN
    affines and running statistics, in place on a numpy tree."""
    rs = np.random.RandomState(seed)

    def walk(params, stats, path=()):
        for k, v in params.items():
            sub = stats.get(k, {}) if stats is not None else None
            if isinstance(v, dict):
                walk(v, sub, path + (k,))
            elif "conv_offset" in path and k == "kernel":
                fan_in = np.prod(v.shape[:-1])
                params[k] = (rs.randn(*v.shape) * 0.25 / np.sqrt(fan_in)
                             ).astype(np.float32)
            elif "conv_offset" in path and k == "bias":
                params[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
            elif stats is not None and "mean" in stats and k in ("scale",
                                                                 "bias"):
                lo = 0.8 if k == "scale" else -0.1
                params[k] = (lo + (0.4 if k == "scale" else 0.2)
                             * rs.rand(*v.shape)).astype(np.float32)
        if stats is not None and "mean" in stats:
            stats["mean"] = (0.1 * rs.randn(*stats["mean"].shape)
                             ).astype(np.float32)
            stats["var"] = (0.5 + rs.rand(*stats["var"].shape)
                            ).astype(np.float32)

    walk(variables["params"], variables.get("batch_stats"))
    return variables


def _nchw(a, dtype=torch.float64):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).to(
        dtype).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _close(got, ref, rtol, what=""):
    """|got - ref| <= rtol * max|ref| everywhere."""
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e}, max {scale:.3e}"


# --- the layer ---------------------------------------------------------

# (kernel_size, stride, padding, use_bias): every option of the reference's
# layer, each value with each of the others' values, at both widths
LAYER_CASES = [(3, 1, 1, True), (3, 2, 1, False), (3, 1, 0, False),
               (3, 2, 0, True), (1, 1, 0, True), (1, 2, 0, False),
               (1, 1, 1, False), (1, 2, 1, True)]


@pytest.mark.parametrize("cin", [64, 128])
@pytest.mark.parametrize("kernel_size,stride,padding,use_bias", LAYER_CASES)
def test_modulated_deform_conv_matches_jax(kernel_size, stride, padding,
                                           use_bias, cin):
    """f32, atol/rtol 1e-4: sums of K*Cin f32 products in another order.
    Random offset/mask conv (std 0.25 / sqrt(fan_in), bias std 0.1), so
    that samples leave the integer grid."""
    rs = np.random.RandomState(kernel_size + 3 * stride + 5 * padding + cin)
    k, fan_in = kernel_size, kernel_size ** 2 * cin
    params = {"conv_offset": {
        "kernel": (rs.randn(k, k, cin, 3 * k * k) * 0.25 / np.sqrt(fan_in)
                   ).astype(np.float32),
        "bias": (0.1 * rs.randn(3 * k * k)).astype(np.float32)},
        "kernel": (rs.randn(k, k, cin, 16) / np.sqrt(fan_in)
                   ).astype(np.float32)}
    if use_bias:
        params["bias"] = rs.randn(16).astype(np.float32)
    x = rs.randn(2, 9, 10, cin).astype(np.float32)
    jlayer = JaxDCN(16, kernel_size=kernel_size, stride=stride,
                    padding=padding, use_bias=use_bias)
    ref = np.asarray(jax.jit(jlayer.apply)({"params": params},
                                           jnp.asarray(x)))

    layer = ModulatedDeformConv(cin, 16, kernel_size=kernel_size,
                                stride=stride, padding=padding,
                                use_bias=use_bias)
    assert (layer.bias is not None) == use_bias
    assert layer.conv_offset.out_channels == 3 * kernel_size ** 2
    load_from_flax(layer, {"params": params})
    got = layer(_nchw(x, torch.float32))
    ho, wo, _ = dcn_sampling_grid_shapes(9, 10, kernel_size, stride, padding)
    assert ref.shape == (2, ho, wo, 16)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-4)


def test_modulated_deform_conv_starts_as_modulated_conv():
    """A new layer's offset/mask conv is zero, as the reference's."""
    layer = ModulatedDeformConv(64, 8, kernel_size=1, stride=2, padding=0,
                                use_bias=True)
    for t in (layer.conv_offset.weight, layer.conv_offset.bias, layer.bias):
        assert float(t.detach().abs().max()) == 0.0


def test_dcn_bias_is_added_before_the_one_rounding():
    """bf16 x, weights and bias: the reference sums in f32, adds the bias
    and rounds once. The port must give the same bf16 values as the JAX
    layer (zero offsets, no mask: the samples are x itself on both sides,
    so only the contraction and the bias differ): at most a few elements
    apart, by one ulp, where f32 summation order decides a rounding. Adding
    the bias after a bf16 matmul has rounded (two roundings) puts ~1 in 5
    elements one ulp off."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 12, 12, 64).astype(np.float32)
    w = (rs.randn(3, 3, 64, 32) / 24).astype(np.float32)
    bias = (3 * rs.randn(32)).astype(np.float32)
    offs = np.zeros((2, 12, 12, 9, 2), np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = np.asarray(jax_dcn(bf(x), jnp.asarray(offs), None, bf(w), bf(bias),
                             implementation="xla").astype(jnp.float32))
    t = lambda a: torch.from_numpy(a).bfloat16()
    got = deform_conv2d(t(x), torch.from_numpy(offs), None, t(w), t(bias))
    assert got.dtype == torch.bfloat16
    diff = got.float().numpy() != ref
    assert diff.mean() < 2e-3, diff.mean()
    ulp = np.exp2(np.floor(np.log2(np.abs(ref[diff]))) - 7)
    assert (np.abs(got.float().numpy()[diff] - ref[diff]) <= ulp).all()


# --- the backbone ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_init():
    """Flax init of the four-stage-DCN CenterNet at 4 classes (its
    ``backbone`` subtree is the ResNet's)."""
    jmodel = JaxCenterNetDcn4(num_classes=4)
    init = jax.jit(lambda key, x: jmodel.init(key, x, train=False))
    return _numpy_tree(init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


@pytest.fixture(scope="module")
def backbone(jax_init):
    """The JAX ResNet-18 with DCN in four stages (f64 compute), randomized
    variables, and the port's copy of it (f64 parameters: the f32 values
    widened, which is what the JAX side computes with)."""
    variables = _randomize(
        {col: _numpy_tree(jax_init[col]["backbone"])
         for col in ("params", "batch_stats")}, seed=3)
    image = np.random.RandomState(2).randn(2, 64, 64, 3)
    with jax.enable_x64(True):
        jnet = JaxResNet(depth=18, dcn_stages=DCN4, dtype=jnp.float64)
        ref_eval = [np.asarray(o) for o in jax.jit(
            lambda v, x: jnet.apply(v, x, train=False))(
                variables, jnp.asarray(image))]
        cots = [np.random.RandomState(10 + i).randn(*o.shape)
                for i, o in enumerate(ref_eval)]

        def train_vjp(params, img, cot):
            def fwd(p, x):
                return jnet.apply(
                    {"params": p, "batch_stats": variables["batch_stats"]},
                    x, train=True, mutable=["batch_stats"])
            outs, vjp, mutated = jax.vjp(fwd, params, img, has_aux=True)
            return outs, mutated, vjp(cot)

        outs, mutated, (dparams, dimage) = jax.jit(train_vjp)(
            variables["params"], jnp.asarray(image),
            tuple(jnp.asarray(c) for c in cots))
        ref_train = dict(outs=[np.asarray(o) for o in outs],
                         stats=_numpy_tree(mutated["batch_stats"]),
                         dparams=_numpy_tree(dparams),
                         dimage=np.asarray(dimage))
    net = ResNet(18, dcn_stages=DCN4)
    load_from_flax(net, variables)
    net = net.double().to(memory_format=torch.channels_last)
    return dict(net=net, image=image, ref_eval=ref_eval, cots=cots,
                ref_train=ref_train)


def test_resnet_dcn4_stage1_is_flat_dcn(backbone):
    """Stage 1's conv2 layers are 64 -> 64 DCN layers: Cin % 128 != 0."""
    net = backbone["net"]
    for name in ("layer1_0", "layer1_1"):
        conv2 = getattr(net, name).conv2
        assert isinstance(conv2, ModulatedDeformConv)
        assert tuple(conv2.kernel.shape) == (3, 3, 64, 64)
    assert sum(isinstance(m, ModulatedDeformConv)
               for m in net.modules()) == 8


def test_resnet_dcn4_eval_matches_jax(backbone):
    """Eval forward, all four outputs, f64: within 1e-6 of each output's
    largest value (the port's sample coordinates are f32)."""
    net = backbone["net"].eval()
    with torch.no_grad():
        outs = net(_nchw(backbone["image"]))
    for i, (o, r) in enumerate(zip(outs, backbone["ref_eval"])):
        assert o.shape == (2, r.shape[3], r.shape[1], r.shape[2])
        _close(_nhwc(o), r, 1e-6, f"C{i + 2}")


def test_resnet_dcn4_train_and_vjp_match_jax(backbone):
    """Train-mode forward (f64), and the vector-Jacobian product of the
    four outputs against the same cotangents: the outputs, every BN running
    statistic after the update, every parameter's gradient and the image's
    within 2e-5 of the tensor's largest value. The port's sample
    coordinates are f32 (``ops/dcn.py``), the reference's f64 here: ~1e-7
    relative per coordinate, which the train-mode BNs' batch statistics
    over 8 to 512 values per channel grow to a few 1e-6."""
    import copy

    net = copy.deepcopy(backbone["net"]).train()
    ref = backbone["ref_train"]
    image = _nchw(backbone["image"]).requires_grad_()
    outs = net(image)
    for i, (o, r) in enumerate(zip(outs, ref["outs"])):
        _close(_nhwc(o), r, 2e-5, f"train C{i + 2}")
    torch.autograd.backward(outs, [_nchw(c) for c in backbone["cots"]])
    ref_net = ResNet(18, dcn_stages=DCN4)
    load_from_flax(ref_net, {"params": ref["dparams"],
                             "batch_stats": ref["stats"]})
    grads = dict(net.named_parameters())
    for name, r in ref_net.named_parameters():
        assert grads[name].grad is not None, name
        _close(grads[name].grad.numpy(), r.detach().numpy(), 2e-5, name)
    bufs = dict(net.named_buffers())
    for name, r in ref_net.named_buffers():
        if "running" in name:
            _close(bufs[name].numpy(), r.numpy(), 2e-5, name)
    _close(_nhwc(image.grad), ref["dimage"], 2e-5, "image")
    # stage 1's offsets are off the grid here and take a gradient
    assert float(net.layer1_0.conv2.conv_offset.weight.grad.abs().max()) > 0


# --- the detector -------------------------------------------------------

def _port_centernet(num_classes, variables, dtype):
    model = CenterNet(num_classes=num_classes, dtype=dtype)
    model.backbone = ResNet(18, dcn_stages=DCN4)
    return centernet_from_flax(model, variables).to(
        memory_format=torch.channels_last)


def test_carrier_is_a_bijection(jax_init):
    """Every flax leaf lands in exactly one port tensor (the stage-1
    conv2's offset conv and kernel included), unchanged; a leaf left over
    or missing raises."""
    model = _port_centernet(4, jax_init, torch.float32)
    leaves = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_init[col])[0]:
            leaves[(col,) + tuple(k.key for k in path)] = leaf
    n_port = len(list(model.parameters())) + sum(
        1 for n, _ in model.named_buffers() if "running" in n)
    assert n_port == len(leaves)
    p = jax_init["params"]["backbone"]["layer1_0"]["conv2"]
    np.testing.assert_array_equal(
        model.backbone.layer1_0.conv2.kernel.detach().numpy(), p["kernel"])
    np.testing.assert_array_equal(
        model.backbone.layer1_0.conv2.conv_offset.weight.detach().numpy(),
        p["conv_offset"]["kernel"].transpose(3, 2, 0, 1))
    extra = _numpy_tree(jax_init)
    extra["params"]["backbone"]["layer1_0"]["conv2"]["spare"] = \
        np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no port tensor"):
        _port_centernet(4, extra, torch.float32)
    missing = _numpy_tree(jax_init)
    del missing["params"]["backbone"]["layer1_1"]["conv2"]["conv_offset"]
    with pytest.raises(KeyError, match="missing"):
        _port_centernet(4, missing, torch.float32)
    flagship = CenterNet(num_classes=4)
    with pytest.raises(ValueError, match="no port tensor"):
        centernet_from_flax(flagship, jax_init)


def test_centernet_dcn4_predict_matches_jax(jax_init):
    """predict (forward + top-100 decode) with randomized offsets and BN,
    f64 compute: boxes and scores within 1e-6, classes equal."""
    variables = _randomize(_numpy_tree(jax_init), seed=4)
    image = np.random.RandomState(5).randn(2, 64, 64, 3)
    with jax.enable_x64(True):
        jmodel = JaxCenterNetDcn4(num_classes=4, dtype=jnp.float64)
        ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, method=jmodel.predict))(variables, jnp.asarray(image)))
    model = _port_centernet(4, variables, torch.float64).double().eval()
    got = model.predict(torch.from_numpy(image)).numpy()
    assert got.shape == ref.shape == (2, 100, 6)
    np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])


def _gt_batch(seed=1):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 40, (2, 6, 2))
    wh = rs.uniform(6, 24, (2, 6, 2))
    return {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_classes": rs.randint(0, 4, (2, 6)).astype(np.int32),
            "gt_mask": np.array([[1] * 5 + [0], [1] * 3 + [0] * 3], bool)}


@pytest.fixture(scope="module")
def train_step_f64(jax_init):
    """One JAX train step and one port train step of the four-stage-DCN
    CenterNet from the flax init (zero offset convs: every sample on the
    integer grid), f32 parameters, f64 compute."""
    batch = _gt_batch()
    with jax.enable_x64(True):
        jmodel = JaxCenterNetDcn4(num_classes=4, dtype=jnp.float64)
        tx = jax_adamw(LR, clip_global_norm=CLIP)
        jstate = JaxTrainState.create(jax_init["params"],
                                      jax_init["batch_stats"], tx)

        def loss_apply(v, b, train=True):
            return jmodel.apply(v, b, train=train,
                                method=jmodel.loss_from_gt,
                                mutable=["batch_stats"])

        new_jstate, jmetrics = jax_make_train_step(loss_apply, donate=False)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        new_jstate, jmetrics = jax.device_get((new_jstate, jmetrics))
    model = _port_centernet(4, jax_init, torch.float64)
    state = TrainState.create(model, adamw(LR, clip_global_norm=CLIP))
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(lambda m, b: m.loss_from_gt(b))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return new_jstate, jmetrics, state, metrics, old


def test_centernet_dcn4_train_step_matches_jax(train_step_f64):
    """f64 compute: loss and parts rtol 1e-5, grad_norm rtol 1e-4; each
    parameter's update within 1e-3 relative L2 of JAX's (a first Adam step
    is ~lr * sign(g): elements with |g| at the f32 noise of the loss's
    gradient may differ), except the neck's transposed-conv biases, whose
    gradient a train-mode BN cancels; every BN running statistic within
    atol 1e-6."""
    new_jstate, jmetrics, state, metrics, old = train_step_f64
    for name in ("loss", "hm_loss", "wh_loss", "off_loss"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    ref = _port_centernet(4, {"params": new_jstate.params,
                              "batch_stats": new_jstate.batch_stats},
                          torch.float32)
    got = dict(state.model.named_parameters())
    bad = {}
    for name, r in ref.named_parameters():
        if name.startswith("neck.") and name.endswith("up.bias"):
            continue
        mine = got[name].detach() - old[name]
        theirs = r.detach() - old[name]
        err = float((mine - theirs).norm() / theirs.norm())
        if err > 1e-3:
            bad[name] = err
    bufs = dict(state.model.named_buffers())
    for name, r in ref.named_buffers():
        if "running" in name:
            err = float((bufs[name] - r).abs().max())
            if err > 1e-6:
                bad[name] = err
    assert not bad, bad


def test_stage1_offsets_get_gradients_at_init(train_step_f64):
    """At the flax init every sample sits on the integer grid; stage 1's
    offset convs (the flat sampler's coordinates) still get a gradient and
    move, because the port's backward takes forward differences there (the
    reference's Pallas backward returns zero)."""
    model = train_step_f64[2].model
    for name in ("layer1_0", "layer1_1"):
        off = getattr(model.backbone, name).conv2.conv_offset.weight
        assert float(off.grad[:18].abs().max()) > 0, name
        assert float(off.detach()[:18].abs().max()) > 0, name


# --- the entry points ---------------------------------------------------

def test_centernet_dcn4_entry_serves_on_cpu_when_asked():
    """The serving program builds (bf16, 80 classes, 8 DCN layers in the
    backbone) and answers one request at 128x128."""
    predict, (image,) = centernet_dcn4_entry(device="cpu")
    model = predict.__self__
    assert image.shape == (1, 512, 512, 3) and not model.training
    assert isinstance(model.backbone.layer1_0.conv2, ModulatedDeformConv)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    det = predict(image[:, :128, :128])
    assert det.shape == (1, 100, 6) and bool(torch.isfinite(det).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            centernet_dcn4_entry()


def test_centernet_dcn4_train_entry_steps_on_cpu_when_asked():
    """The train program builds (f32 parameters, bf16 compute, AdamW 5e-4,
    clip 35) and takes one step on a 128x128 batch of 2."""
    step_fn, (state, batch) = centernet_dcn4_train_entry(device="cpu",
                                                         batch=2)
    model = state.model
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert isinstance(model.backbone.layer1_1.conv2, ModulatedDeformConv)
    assert batch["image"].shape == (2, 512, 512, 3)
    assert state.tx.clip_global_norm == CLIP and state.tx.learning_rate == LR
    boxes = {k: torch.from_numpy(v)
             for k, v in synthetic_boxes(2, res=128, num_classes=80).items()}
    targets = centernet_targets_batch(boxes["boxes"], boxes["classes"],
                                      boxes["mask"], 32, 32, 80, 0.7)
    state, metrics = step_fn(state, {"image": batch["image"][:, :128, :128],
                                     "targets": targets})
    assert all(np.isfinite(float(v)) for v in metrics.values())
    off = model.backbone.layer1_0.conv2.conv_offset.weight
    assert float(off.grad.abs().max()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            centernet_dcn4_train_entry()
