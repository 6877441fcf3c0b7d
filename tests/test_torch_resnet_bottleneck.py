"""The port's ``Bottleneck`` and deep ResNets vs the JAX package's, f32 on
the CPU.

Flax variables are drawn with numpy from a seed (kernels N(0, 1 / fan_in),
BN scales and variances in [0.6, 1.4), biases and means N(0, 0.01)) and
carried over by ``load_from_flax``; inputs are numpy-random too. The JAX
modules run in eval mode, so ResNet-50 goes through the reference's
``lax.scan`` over each stage's inner Bottlenecks, against the port's
block-by-block path. Tolerance atol = rtol = 1e-4 (f32 convs summed in
another order). In train mode (the R-CNN train step's backbone) the
reference runs its blocks one by one (``backbones/resnet.py:235-245``) and
BN takes the batch's statistics: outputs and the input's gradient within
1e-4, the BN running statistics after the step (flax momentum 0.9) within
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck
from minddet_tpu.models.backbones.resnet import ResNet as JaxResNet
from minddet_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from minddet_tpu_torch.utils.convert import load_from_flax

TOL = dict(rtol=1e-4, atol=1e-4)


def random_variables(shapes, seed=0, gains=None):
    """numpy-random flax variables of the given shapes (a tree of
    ``ShapeDtypeStruct``s); a kernel whose path holds a key of ``gains``
    is scaled by its gain."""
    rs = np.random.RandomState(seed)
    gains = gains or {}

    def leaf(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            gain = next((g for k, g in gains.items() if k in names), 1.0)
            return (rs.randn(*s.shape) * gain / np.sqrt(fan_in)).astype(
                np.float32)
        if names[-1] in ("scale", "var"):
            return rs.uniform(0.6, 1.4, s.shape).astype(np.float32)
        return (rs.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_variables(module, x, seed=0, **kwargs):
    """Random variables for ``module`` applied to ``x`` (eval mode)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    return random_variables({k: dict(v) for k, v in shapes.items()}, seed,
                            **kwargs)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin, features, strides, downsample", [
    (64, 64, 1, True),     # layer1_0: 64 -> 256 at stride 1
    (256, 64, 1, False),   # an inner block
    (256, 128, 2, True),   # layer2_0: stride on the 3x3
    (512, 128, 1, False),
])
def test_bottleneck_matches_jax(cin, features, strides, downsample):
    x = np.random.RandomState(1).randn(2, 8, 8, cin).astype(np.float32)
    jm = JaxBottleneck(features, strides=strides)
    variables = flax_variables(jm, x)
    assert ("downsample_conv" in variables["params"]) == downsample
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = load_from_flax(Bottleneck(cin, features, strides).eval(),
                          variables)
    assert (port.downsample_conv is not None) == downsample
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == ref.shape == (2, 8 // strides, 8 // strides,
                                      4 * features)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("depth", [34, 50])
def test_resnet_outputs_match_jax(depth):
    """ResNet-34 and ResNet-50 at 64 x 64: the four outputs; ResNet-50's
    JAX side scans the inner Bottlenecks of every stage."""
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    jm = JaxResNet(depth=depth)
    variables = flax_variables(jm, x, seed=3)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = load_from_flax(ResNet(depth=depth).eval(), variables)
    assert port.out_channels == jm.out_channels
    with torch.no_grad():
        got = port(_nchw(x))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[1] == port.out_channels[i]
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL,
                                   err_msg=f"C{i + 2}")


def test_resnet_refuses_unknown_depth_and_dcn_bottlenecks():
    with pytest.raises(ValueError):
        ResNet(depth=42)
    with pytest.raises(NotImplementedError):
        ResNet(depth=50, dcn_stages=(False, True, True, True))


def _train_apply(jm, variables, x, g):
    """The reference in train mode: outputs, the mutated BN statistics and
    the gradient of sum(outputs * g) with respect to the input."""
    def f(a):
        out, mutated = jm.apply(variables, a, train=True,
                                mutable=["batch_stats"])
        outs = out if isinstance(out, (tuple, list)) else (out,)
        dot = sum(jnp.sum(o * gi) for o, gi in zip(outs, g))
        return dot, (outs, mutated["batch_stats"])

    (_, (outs, stats)), dx = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    return outs, stats, dx


@pytest.mark.parametrize("which", ["bottleneck", "resnet50"])
def test_train_mode_matches_jax_with_bn_statistics(which):
    """A downsampling Bottleneck (256 -> 512 at stride 2, f32) and
    ResNet-50 at 64 x 64 (f64 compute over f32 parameters on both sides:
    in f32 the batch statistics of 16 chained train-mode blocks over 2 x 8
    x 8 positions move C3 by ~3e-4 between the two), batch 2, in train
    mode: every output, the input's gradient and every BN running
    statistic after the forward."""
    rs = np.random.RandomState(4)
    wide = which == "resnet50"
    if which == "bottleneck":
        x = rs.randn(2, 8, 8, 256).astype(np.float32)
        jm, port = JaxBottleneck(128, strides=2), Bottleneck(256, 128, 2)
    else:
        x = rs.randn(2, 64, 64, 3).astype(np.float32)
        jm, port = JaxResNet(depth=50, dtype=jnp.float64), ResNet(depth=50)
    with jax.enable_x64(wide):
        variables = flax_variables(jm, x, seed=5)
        port = load_from_flax(port, variables).train()
        xt = _nchw(x).to(torch.float64 if wide else torch.float32)
        xt.requires_grad_()
        outs = port(xt)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = [rs.randn(*_nhwc(o.detach()).shape).astype(np.float32)
             for o in outs]
        sum((o * _nchw(gi)).sum() for o, gi in zip(outs, g)).backward()
        ref_outs, ref_stats, ref_dx = _train_apply(
            jm, variables, x.astype(np.float64) if wide else x, g)
    for i, (o, r) in enumerate(zip(outs, ref_outs)):
        np.testing.assert_allclose(_nhwc(o.detach()), np.asarray(r), **TOL,
                                   err_msg=f"output {i}")
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(ref_dx), **TOL)
    fresh = ResNet(depth=50) if wide else Bottleneck(256, 128, 2)
    ref = load_from_flax(fresh, {"params": variables["params"],
                                 "batch_stats": ref_stats})
    got = dict(port.named_buffers())
    moved = 0
    for n, r in ref.named_buffers():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
        moved += 1
    assert moved == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                            for m in port.modules())
