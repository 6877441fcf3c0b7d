"""The port's whole CenterNet vs the JAX package's, f32 on the CPU.

``CenterNet(num_classes=4, depth=18, dcn=True)`` at (2, 64, 64, 3): flax
init, then random ``conv_offset`` weights (so every DCN samples off the
integer grid) and random BN parameters and running statistics, all carried
over by ``centernet_from_flax``. Heads agree to atol 1e-4 / rtol 1e-3 (some
20 conv layers in f32, summed in another order than XLA); ``predict`` gives
the same classes and positions and scores/boxes to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.utils.convert import centernet_from_flax


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize_flax(variables, seed=0, offset_std=1.0):
    """Random offset convs and BN statistics, made with numpy.

    ``offset_std`` is in pixels per unit input: the offset kernel's std is
    offset_std / sqrt(fan_in).
    """
    rs = np.random.RandomState(seed)
    params = _to_numpy(variables["params"])
    stats = _to_numpy(variables["batch_stats"])

    def walk(p, s):
        for name, node in p.items():
            if name == "conv_offset":
                k = node["kernel"]
                fan_in = k.shape[0] * k.shape[1] * k.shape[2]
                node["kernel"] = (rs.randn(*k.shape) * offset_std
                                  / np.sqrt(fan_in)).astype(np.float32)
                node["bias"] = (rs.randn(*node["bias"].shape) * 0.1
                                ).astype(np.float32)
            elif s is not None and name in s and "mean" in s[name]:
                c = node["scale"].shape
                node["scale"] = rs.uniform(0.8, 1.2, c).astype(np.float32)
                node["bias"] = (rs.randn(*c) * 0.1).astype(np.float32)
                s[name]["mean"] = (rs.randn(*c) * 0.1).astype(np.float32)
                s[name]["var"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(node, dict):
                walk(node, None if s is None else s.get(name))

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxCenterNet(num_classes=4, depth=18, dcn=True)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            train=False)
    variables = randomize_flax(variables)
    tmodel = centernet_from_flax(CenterNet(num_classes=4).eval(), variables)
    image = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    return jmodel, variables, tmodel, image


def test_heads_match_jax(models):
    jmodel, variables, tmodel, image = models
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(image))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(image))
    assert set(got) == set(ref) == {"hm", "wh", "reg"}
    for name in ref:
        r = np.asarray(ref[name])
        assert got[name].shape == r.shape
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    # the random offsets really moved the samples: not a plain-conv model
    assert np.abs(np.asarray(ref["hm"])).std() > 0


def test_predict_matches_jax(models):
    jmodel, variables, tmodel, image = models
    ref = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, method=jmodel.predict))(
            variables, jnp.asarray(image)))
    got = tmodel.predict(torch.from_numpy(image)).numpy()
    assert got.shape == ref.shape == (2, 100, 6)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # classes
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_dcn_inputs_are_channels_last(models):
    """Every DCN layer reads a contiguous NHWC view (no per-layer copy)."""
    _, _, tmodel, image = models
    from minddet_tpu_torch.models.layers import ModulatedDeformConv

    seen = []

    def hook(_, args):
        seen.append(args[0].permute(0, 2, 3, 1).is_contiguous())

    handles = [m.register_forward_pre_hook(hook) for m in tmodel.modules()
               if isinstance(m, ModulatedDeformConv)]
    try:
        tmodel.predict(torch.from_numpy(image))
    finally:
        for h in handles:
            h.remove()
    assert seen == [True] * 9
