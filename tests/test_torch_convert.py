"""The flax -> port weight carrier, the DeconvBlock it pins, and the entry
point's refusal to run on the CPU unasked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu.models.layers import DeconvBlock as JaxDeconvBlock
from minddet_tpu_torch.entry import entry
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.layers import DeconvBlock
from minddet_tpu_torch.utils.convert import (centernet_from_flax,
                                             load_from_flax)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flax_variables():
    model = JaxCenterNet(num_classes=3, depth=18, dcn=True)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                           train=False))
    rs = np.random.RandomState(0)
    # distinct random values per leaf, so a leaf loaded into the wrong
    # tensor (or twice) is seen
    return jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32),
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])})


def test_carrier_is_a_bijection(flax_variables):
    port = centernet_from_flax(CenterNet(num_classes=3), flax_variables)
    n_flax = sum(1 for col in flax_variables.values() for _ in _leaves(col))
    tensors = dict(port.named_parameters())
    tensors.update((n, b) for n, b in port.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    assert len(tensors) == n_flax
    # every flax leaf's values appear in exactly one port tensor
    port_sums = sorted(float(t.detach().double().sum()) for t in tensors.values())
    flax_sums = sorted(float(np.sum(a, dtype=np.float64))
                       for col in flax_variables.values()
                       for _, a in _leaves(col))
    np.testing.assert_allclose(port_sums, flax_sums, rtol=1e-6, atol=1e-6)
    k = flax_variables["params"]["backbone"]["layer2_0"]["conv2"]["kernel"]
    np.testing.assert_array_equal(
        port.backbone.layer2_0.conv2.kernel.detach().numpy(), k)


def test_carrier_rejects_extra_and_missing_leaves(flax_variables):
    extra = jax.tree_util.tree_map(lambda a: a, flax_variables)
    extra["params"]["head"]["hm"]["spare"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no port tensor"):
        centernet_from_flax(CenterNet(num_classes=3), extra)
    missing = jax.tree_util.tree_map(lambda a: a, flax_variables)
    del missing["batch_stats"]["neck"]["deconv1"]["BatchNorm_0"]["var"]
    with pytest.raises(KeyError, match="BatchNorm_0/var"):
        centernet_from_flax(CenterNet(num_classes=3), missing)
    with pytest.raises(ValueError, match="shape"):
        centernet_from_flax(CenterNet(num_classes=4), flax_variables)


@pytest.mark.parametrize("cin,features", [(128, 16), (16, 16)])
def test_deconv_block_matches_jax(cin, features):
    """One DeconvBlock, all weights random (offsets too): pins the
    ConvTranspose flip and the BN names; f32 atol 1e-4 / rtol 1e-4."""
    jblock = JaxDeconvBlock(features)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, 5, cin).astype(np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    variables = jax.tree_util.tree_map(
        lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])})
    for bn in ("BatchNorm_0", "BatchNorm_1"):
        var = variables["batch_stats"][bn]["var"]
        variables["batch_stats"][bn]["var"] = np.abs(var) + 0.5
    ref = jblock.apply(variables, jnp.asarray(x), train=False)

    block = load_from_flax(DeconvBlock(cin, features).eval(), variables)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 12, 10, features)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_entry_on_cpu_when_asked():
    predict, (image,) = entry(device="cpu", batch=1)
    assert image.shape == (1, 512, 512, 3)
    model = predict.__self__
    param = next(model.parameters())
    assert param.device.type == "cpu" and param.dtype == torch.bfloat16
    assert model.num_classes == 80
    out = predict(image)
    assert out.shape == (1, 100, 6) and torch.isfinite(out).all()


# --- PointPillars -------------------------------------------------------

from minddet_tpu.models.detectors.pointpillars import (  # noqa: E402
    PointPillars as JaxPointPillars)
from minddet_tpu.models.necks.second_rpn import (  # noqa: E402
    SECONDRPN as JaxSECONDRPN)
from minddet_tpu_torch.models.detectors.pointpillars import (  # noqa: E402
    PointPillars)
from minddet_tpu_torch.models.necks.second_rpn import SECONDRPN  # noqa: E402
from minddet_tpu_torch.utils.convert import (  # noqa: E402
    pointpillars_from_flax)

_PP_TINY = dict(num_classes=1, grid_ny=32, grid_nx=32,
                voxel_size=(0.2, 0.2, 4.0),
                pc_range=(0.0, -3.2, -3.0, 6.4, 3.2, 1.0),
                rpn_layer_nums=(2, 1, 1), rpn_filters=(16, 32, 64),
                rpn_up_filters=(16, 16, 16), max_voxels=256,
                max_points_per_voxel=8, anchor_strides=((0.4, 0.4, 0.0),),
                anchor_offsets=((0.2, -3.0, -1.78),))


def _random_like(shapes, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("s2d,scan", [(True, True), (False, False)])
def test_pointpillars_carrier_is_a_bijection(s2d, scan):
    """The flax tree (one layout with or without space-to-depth and the
    scanned inner layers) loads leaf for leaf; the Dense kernel is
    transposed; the anchors buffer is no weight."""
    jm = JaxPointPillars(**_PP_TINY, rpn_space_to_depth=s2d,
                         rpn_scan_inner=scan, rpn_scan_min_layers=2)
    pts = jnp.zeros((1, 64, 4))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts, jnp.ones((1, 64), bool),
        method=jm.predict_from_points))
    variables = _random_like({"params": dict(shapes["params"]),
                              "batch_stats": dict(shapes["batch_stats"])}, 5)
    port = pointpillars_from_flax(PointPillars(**_PP_TINY), variables)
    n_flax = sum(1 for col in variables.values() for _ in _leaves(col))
    state = port.state_dict()
    tensors = {n: t for n, t in state.items()
               if not n.endswith("num_batches_tracked")}
    assert len(tensors) == n_flax and "anchors" not in state
    port_sums = sorted(float(t.double().sum()) for t in tensors.values())
    flax_sums = sorted(float(np.sum(a, dtype=np.float64))
                       for col in variables.values() for _, a in _leaves(col))
    np.testing.assert_allclose(port_sums, flax_sums, rtol=1e-6, atol=1e-6)
    dense = variables["params"]["reader"]["pfn0"]["linear"]["kernel"]
    np.testing.assert_array_equal(
        port.reader.pfn0.linear.weight.detach().numpy(), dense.T)
    np.testing.assert_array_equal(
        port.reader.pfn0.norm.running_var.numpy(),
        variables["batch_stats"]["reader"]["pfn0"]["norm"]["var"])
    stacked = JaxPointPillars(**_PP_TINY, rpn_stacked_params=True,
                              rpn_scan_min_layers=2)
    shapes = jax.eval_shape(lambda: stacked.init(
        jax.random.PRNGKey(0), pts, jnp.ones((1, 64), bool),
        method=stacked.predict_from_points))
    with pytest.raises(KeyError, match="block0_0_conv"):
        pointpillars_from_flax(PointPillars(**_PP_TINY), _random_like(
            {"params": dict(shapes["params"]),
             "batch_stats": dict(shapes["batch_stats"])}, 5))


@pytest.mark.parametrize("layer_nums", [(1, 2, 1), (2, 0, 1)])
def test_second_rpn_matches_jax(layer_nums):
    """The RPN alone, f32: its three up blocks are flax ConvTransposes at
    kernel = stride 1, 2 and 4 (the flip rule, padding 0), with random BN
    statistics; atol 1e-4 / rtol 1e-4."""
    kw = dict(layer_nums=layer_nums, layer_strides=(2, 2, 2),
              num_filters=(8, 16, 16), upsample_strides=(1, 2, 4),
              num_upsample_filters=(8, 8, 8))
    jrpn = JaxSECONDRPN(**kw)
    rs = np.random.RandomState(sum(layer_nums))
    x = rs.randn(2, 16, 24, 6).astype(np.float32)
    shapes = jax.eval_shape(lambda: jrpn.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    variables = _random_like({"params": dict(shapes["params"]),
                              "batch_stats": dict(shapes["batch_stats"])},
                             sum(layer_nums))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if getattr(p[-1], "key", "") == "var"
        else a * 0.3, variables)
    ref = np.asarray(jrpn.apply(variables, jnp.asarray(x)))
    port = load_from_flax(SECONDRPN(6, **kw).eval(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 8, 12, 24)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# --- CenterPoint ---------------------------------------------------------

from minddet_tpu.models.detectors.centerpoint import (  # noqa: E402
    CenterPoint as JaxCenterPoint)
from minddet_tpu.models.detectors.centerpoint import (  # noqa: E402
    CenterPointTwoStage as JaxCenterPointTwoStage)
from minddet_tpu_torch.models.detectors.centerpoint import (  # noqa: E402
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.utils.convert import (  # noqa: E402
    centerpoint_from_flax)

_CP_TINY = dict(task_num_classes=(1, 2), grid_ny=32, grid_nx=32,
                voxel_size=(0.2, 0.2, 8.0),
                pc_range=(-3.2, -3.2, -5.0, 3.2, 3.2, 3.0),
                pfn_filters=(16, 16), rpn_layer_nums=(1, 1, 1),
                rpn_filters=(16, 32, 64), rpn_up_filters=(16, 16, 16),
                max_voxels=64, max_points_per_voxel=4)


def _centerpoint_variables(two_stage, seed, **jax_kw):
    if two_stage:
        jm = JaxCenterPointTwoStage(**_CP_TINY, refine_hidden=32, **jax_kw)
        method = jm.predict_refined
    else:
        jm = JaxCenterPoint(**_CP_TINY, **jax_kw)
        method = jm.predict_from_points
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 5)), jnp.ones((1, 64), bool),
        method=method))
    return _random_like({"params": dict(shapes["params"]),
                         "batch_stats": dict(shapes["batch_stats"])}, seed)


@pytest.mark.parametrize("two_stage", [False, True],
                         ids=["one_stage", "two_stage"])
def test_centerpoint_carrier_is_a_bijection(two_stage):
    """Every flax leaf of the (two-stage) CenterPoint lands in exactly one
    tensor of the port and none is left over: the two PFN layers, the RPN
    with its strided ``up0_downconv``, the shared conv, every task's
    branches and, for the two-stage model, the refine MLP (the extractor
    has no parameters)."""
    variables = _centerpoint_variables(two_stage, 9)
    port = (CenterPointTwoStage(**_CP_TINY, refine_hidden=32) if two_stage
            else CenterPoint(**_CP_TINY))
    port = centerpoint_from_flax(port, variables)
    n_flax = sum(1 for col in variables.values() for _ in _leaves(col))
    tensors = {n: t for n, t in port.state_dict().items()
               if not n.endswith("num_batches_tracked")}
    assert len(tensors) == n_flax
    port_sums = sorted(float(t.double().sum()) for t in tensors.values())
    flax_sums = sorted(float(np.sum(a, dtype=np.float64))
                       for col in variables.values() for _, a in _leaves(col))
    np.testing.assert_allclose(port_sums, flax_sums, rtol=1e-6, atol=1e-6)
    params, stats = variables["params"], variables["batch_stats"]
    assert "refine" in params if two_stage else "refine" not in params
    assert "extractor" not in params
    np.testing.assert_array_equal(  # Dense kernels transpose
        port.reader.pfn1.linear.weight.detach().numpy(),
        params["reader"]["pfn1"]["linear"]["kernel"].T)
    np.testing.assert_array_equal(  # conv kernels HWIO -> OIHW
        port.rpn.up0_downconv.weight.detach().numpy(),
        params["rpn"]["up0_downconv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        port.head.task1.hm_out.bias.detach().numpy(),
        params["head"]["task1"]["hm_out"]["bias"])
    np.testing.assert_array_equal(
        port.head.task0.rot_bn0.running_var.numpy(),
        stats["head"]["task0"]["rot_bn0"]["var"])
    if two_stage:
        np.testing.assert_array_equal(
            port.refine.box.weight.detach().numpy(),
            params["refine"]["box"]["kernel"].T)
        np.testing.assert_array_equal(
            port.refine.bn1.running_mean.numpy(),
            stats["refine"]["bn1"]["mean"])


def test_centerpoint_carrier_rejects_what_does_not_fit():
    """A one-stage tree does not fill the two-stage model, a two-stage tree
    has leaves the one-stage model cannot take, and a refine MLP of another
    width does not fit."""
    one = _centerpoint_variables(False, 10)
    two = _centerpoint_variables(True, 10)
    with pytest.raises(KeyError, match="refine"):
        centerpoint_from_flax(CenterPointTwoStage(**_CP_TINY,
                                                  refine_hidden=32), one)
    with pytest.raises(ValueError, match="no port tensor"):
        centerpoint_from_flax(CenterPoint(**_CP_TINY), two)
    with pytest.raises(ValueError, match="shape"):
        centerpoint_from_flax(CenterPointTwoStage(**_CP_TINY,
                                                  refine_hidden=16), two)
