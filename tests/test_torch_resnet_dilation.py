"""The port's dilated ResNet (``output_stride`` 16 and 8) vs the JAX
package's, f64 on the CPU.

ResNet-18 (``BasicBlock``: both 3x3 convs dilated) at output stride 8
and ResNet-50 (``Bottleneck``) at output strides 16 and 8, batch 2 at
64 x 64, so the dilated stages run on 4 x 4 and 8 x 8 maps whose dilated
taps reach real pixels. ResNet-18 at output stride 16 is DeepLab-18's
backbone, held in ``test_torch_segmentors.py`` on that model's program. Flax variables are numpy-random (kernels at fan-in scale, BN off
identity) and widened to f64, carried over by ``load_from_flax``. In eval
mode ResNet-50's reference runs each stage's inner Bottlenecks through
``_scan_bottlenecks``, which pads and dilates ``conv2`` by the stage's
dilation, against the port's block-by-block path; in train mode both run
block by block on the batch's statistics. C2-C5 within 1e-10 of each map's
largest value, and after the train-mode call every BN running statistic
(flax momentum 0.9) within 1e-10 of its largest value. The reference runs
jitted; both output strides of a depth share its variables.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_yolov8 import _assert_close, _flax_variables, _nchw, _nhwc

from minddet_tpu.models.backbones.resnet import ResNet as JaxResNet
from minddet_tpu_torch.models.backbones.resnet import ResNet
from minddet_tpu_torch.utils.convert import load_from_flax

RTOL = 1e-10
SIDE = 64
# output stride -> the sides of C2-C5 at SIDE
SIDES = {16: (16, 8, 4, 4), 8: (16, 8, 8, 8)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(tree, prefix=()):
    """Flatten flax ``batch_stats`` to {port buffer name: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_stats(v, prefix + (k,)))
        else:
            name = {"mean": "running_mean", "var": "running_var"}[k]
            out[".".join(prefix + (name,))] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=1)
def _variables(depth):
    """numpy-random f64 variables of the depth's ResNet (the same shapes at
    every output stride)."""
    jm = JaxResNet(depth=depth, dtype=jnp.float64)
    with jax.enable_x64(True):
        return _flax_variables(jm, jnp.zeros((2, SIDE, SIDE, 3)), seed=depth)


@pytest.fixture(scope="module", params=[(18, 8), (50, 16), (50, 8)],
                ids=lambda p: f"r{p[0]}-os{p[1]}")
def reference(request):
    """The reference's C2-C5 in eval and in train mode, and the running
    statistics after the train-mode call, from one jitted program."""
    depth, output_stride = request.param
    x = np.random.RandomState(depth + output_stride).randn(2, SIDE, SIDE, 3)
    jm = JaxResNet(depth=depth, output_stride=output_stride,
                   dtype=jnp.float64)
    variables = _variables(depth)
    with jax.enable_x64(True):
        both = jax.jit(lambda v, a: (
            jm.apply(v, a, train=False),
            jm.apply(v, a, train=True, mutable=["batch_stats"])))
        eval_out, (train_out, mutated) = jax.device_get(
            both(variables, jnp.asarray(x)))
    return dict(depth=depth, output_stride=output_stride, x=x,
                variables=variables, eval=eval_out, train=train_out,
                stats=_stats(mutated["batch_stats"]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dilated_resnet_matches_jax_f64(reference, train):
    r = reference
    port = load_from_flax(
        ResNet(depth=r["depth"], output_stride=r["output_stride"]).double(),
        r["variables"]).train(train)
    with torch.no_grad():
        got = port(_nchw(r["x"]))
    assert [g.shape[2] for g in got] == list(SIDES[r["output_stride"]])
    for i, (g, want) in enumerate(zip(got, r["train" if train else "eval"])):
        assert g.shape[1] == port.out_channels[i]
        _assert_close(_nhwc(g), want, RTOL)
    if train:
        buffers = {n: b.numpy() for n, b in port.named_buffers()
                   if "running" in n}
        assert sorted(buffers) == sorted(r["stats"])
        for n, want in r["stats"].items():
            _assert_close(buffers[n], want, RTOL)


def test_dilated_blocks_take_the_references_strides_and_dilations():
    """The first block of a dilated stage runs at stride 1 with the new
    dilation (torchvision's ``replace_stride_with_dilation`` would give it
    the previous one); a BasicBlock dilates both 3x3 convs; the downsample
    branch stays where the channels change."""
    r50 = ResNet(depth=50, output_stride=8)
    for name, stride, dilation in (("layer2_0", 2, 1), ("layer3_0", 1, 2),
                                   ("layer3_5", 1, 2), ("layer4_0", 1, 4),
                                   ("layer4_2", 1, 4)):
        conv2 = getattr(r50, name).conv2
        assert (conv2.stride, conv2.dilation, conv2.padding) == (
            (stride,) * 2, (dilation,) * 2, (dilation,) * 2), name
    assert r50.layer4_0.downsample_conv.stride == (1, 1)
    r18 = ResNet(depth=18, output_stride=16)
    for conv in (r18.layer4_0.conv1, r18.layer4_0.conv2, r18.layer4_1.conv1):
        assert (conv.stride, conv.dilation, conv.padding) == (
            (1, 1), (2, 2), (2, 2))
    assert r18.layer3_0.conv1.stride == (2, 2)
    with pytest.raises(ValueError):
        ResNet(depth=50, output_stride=4)
