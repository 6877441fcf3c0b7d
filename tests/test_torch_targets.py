"""The port's CenterNet and CenterPoint targets and losses vs the JAX
package's, f32 on the CPU, inputs made with numpy from a seed.

Targets are the same arithmetic on the same f32 values (atol 1e-6 for the
Gaussian heatmaps, whose exp may round differently; indices exact). Loss
values and gradients: atol/rtol 1e-5, sums over a few thousand terms in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.models import losses as jl
from minddet_tpu.ops import box as jbox
from minddet_tpu.ops import targets as jt
from minddet_tpu.train.train import synthetic_points_batches
from minddet_tpu_torch.entry import synthetic_boxes, synthetic_lidar_batch
from minddet_tpu_torch.models import losses as tl
from minddet_tpu_torch.ops import box as tbox
from minddet_tpu_torch.ops import targets as tt


def _boxes(b=3, o=12, hw=32, c=5, seed=0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(-4, hw - 6, (b, o, 2))
    wh = rs.uniform(0, 14, (b, o, 2))
    wh[:, :2] = 0.0  # degenerate boxes drop out of reg_mask
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rs.randint(0, c, (b, o)).astype(np.int32)
    mask = rs.rand(b, o) < 0.8
    return boxes, classes, mask


def test_gaussian_radius_matches_jax():
    rs = np.random.RandomState(1)
    h, w = (rs.uniform(0, 60, 50).astype(np.float32) for _ in range(2))
    for ov in (0.3, 0.7):
        ref = np.asarray(jt.gaussian_radius((jnp.asarray(h), jnp.asarray(w)),
                                            ov))
        got = tt.gaussian_radius((torch.from_numpy(h), torch.from_numpy(w)),
                                 ov).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("hw,c,seed", [(32, 5, 0), (24, 80, 1)])
def test_centernet_targets_batch_matches_jax(hw, c, seed):
    boxes, classes, mask = _boxes(hw=hw, c=c, seed=seed)
    ref = jt.centernet_targets_batch(jnp.asarray(boxes), jnp.asarray(classes),
                                     jnp.asarray(mask), hw, hw, c, 0.7)
    got = tt.centernet_targets_batch(torch.from_numpy(boxes),
                                     torch.from_numpy(classes),
                                     torch.from_numpy(mask), hw, hw, c, 0.7)
    assert set(got) == set(ref)
    for name in ref:
        r = np.asarray(ref[name])
        assert got[name].shape == r.shape, name
        if name == "ind":
            np.testing.assert_array_equal(got[name].numpy(), r)
        else:
            np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                       atol=1e-6, err_msg=name)
    assert (np.asarray(ref["hm"]) == 1.0).sum() > 0  # peaks were drawn
    one = tt.centernet_targets(*(torch.from_numpy(a[1]) for a in
                                 (boxes, classes, mask)), hw, hw, c)
    np.testing.assert_allclose(one["hm"].numpy(), got["hm"][1].numpy())


def test_draw_gaussians_class_indices_as_jax():
    """Out-of-range classes: a negative index counts from the end and one
    still outside [0, C) is dropped, as ``.at[].max(mode="drop")`` does."""
    centers = np.array([[[4.0, 4.0], [10.0, 3.0], [6.0, 12.0],
                         [12.0, 12.0]]], np.float32)
    radii = np.full((1, 4), 2.0, np.float32)
    classes = np.array([[-1, 3, 7, 1]], np.int32)
    mask = np.ones((1, 4), bool)
    ref = jax.vmap(jt.draw_gaussians, in_axes=(0, 0, 0, 0, None, None,
                                               None))(
        *map(jnp.asarray, (centers, radii, classes, mask)), 16, 16, 4)
    got = tt.draw_gaussians(*map(torch.from_numpy,
                                 (centers, radii, classes, mask)), 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert got[0, 4, 4, 3] == 1.0  # class -1 landed in plane 3
    assert got[0, 12, 6].max() == 0.0  # class 7 dropped


def _heads(b=2, hw=16, c=5, seed=3):
    rs = np.random.RandomState(seed)
    boxes, classes, mask = _boxes(b=b, hw=hw, c=c, seed=seed)
    t = jt.centernet_targets_batch(*map(jnp.asarray, (boxes, classes, mask)),
                                   hw, hw, c, 0.7)
    targets = {k: np.array(v) for k, v in t.items()}
    hm = (1 / (1 + np.exp(-rs.randn(b, hw, hw, c)))).astype(np.float32)
    hm = np.clip(hm, 1e-4, 1 - 1e-4)
    wh = (rs.randn(b, hw, hw, 2) * 3).astype(np.float32)
    return hm, wh, targets


def test_focal_loss_value_and_grad_match_jax():
    hm, _, targets = _heads()
    ref, ref_g = jax.value_and_grad(jl.centernet_focal_loss)(
        jnp.asarray(hm), jnp.asarray(targets["hm"]))
    pred = torch.from_numpy(hm).requires_grad_()
    got = tl.centernet_focal_loss(pred, torch.from_numpy(targets["hm"]))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["l1", "sl1"])
def test_gather_reg_loss_value_and_grad_match_jax(mode):
    _, wh, targets = _heads()
    args = (targets["reg_mask"], targets["ind"], targets["wh"])
    ref, ref_g = jax.value_and_grad(
        lambda o: jl.gather_reg_loss(o, *map(jnp.asarray, args), mode=mode))(
        jnp.asarray(wh))
    out = torch.from_numpy(wh).requires_grad_()
    got = tl.gather_reg_loss(out, torch.from_numpy(args[0]),
                             torch.from_numpy(args[1]).long(),
                             torch.from_numpy(args[2]), mode=mode)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="l1/sl1"):
        tl.gather_reg_loss(out, *map(torch.from_numpy, args[:1]),
                           torch.from_numpy(args[1]).long(),
                           torch.from_numpy(args[2]), mode="l2")


def test_synthetic_boxes_follow_the_bench_recipe():
    """``entry.synthetic_boxes`` draws ``bench.py:headline_setup``'s boxes
    (numpy RandomState(1): classes, then per image 8 corners and sizes)."""
    got = synthetic_boxes(3)
    rs = np.random.RandomState(1)
    classes = rs.randint(0, 80, (3, 128)).astype(np.int32)
    np.testing.assert_array_equal(got["classes"], classes)
    for b in range(3):
        xy = rs.uniform(0, 128 - 30, (8, 2))
        wh = rs.uniform(4, 30, (8, 2))
        np.testing.assert_allclose(got["boxes"][b, :8],
                                   np.concatenate([xy, xy + wh], 1),
                                   rtol=1e-6)
    assert got["mask"].sum() == 3 * 8 and not got["boxes"][:, 8:].any()


PCR = (-6.4, -6.4, -5.0, 6.4, 6.4, 3.0)
VOXEL = (0.2, 0.2, 8.0)


def _lidar_boxes(b=3, o=10, c=3, seed=4):
    """Boxes over the 16x16 map of a 12.8 m range: some centres off the
    map, one degenerate footprint, some slots masked out."""
    rs = np.random.RandomState(seed)
    boxes = np.concatenate(
        [rs.uniform(-7.5, 7.5, (b, o, 2)), rs.uniform(-2, 0, (b, o, 1)),
         rs.uniform(0.4, 5.0, (b, o, 3)), rs.uniform(-2, 2, (b, o, 2)),
         rs.uniform(-np.pi, np.pi, (b, o, 1))], -1).astype(np.float32)
    boxes[:, 0, 3] = 0.0
    classes = rs.randint(0, c, (b, o)).astype(np.int32)
    mask = rs.rand(b, o) < 0.8
    return boxes, classes, mask


def _cp_targets(seed=4, c=3):
    boxes, classes, mask = _lidar_boxes(c=c, seed=seed)
    ref = jt.centerpoint_targets_batch(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(mask),
        (16, 16), c, PCR, VOXEL, 4, 0.1, 2.0, 500)
    got = tt.centerpoint_targets_batch(
        torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(mask), (16, 16), c, PCR, VOXEL, 4, 0.1, 2.0)
    return boxes, mask, {k: np.array(v) for k, v in ref.items()}, got


def test_centerpoint_targets_batch_matches_jax():
    """Heatmaps atol 1e-6 (exp), anno_box 1e-6 (log, sin, cos), indices,
    classes and the mask exact."""
    boxes, mask, ref, got = _cp_targets()
    assert set(got) == set(ref) == {"hm", "anno_box", "ind", "mask", "cat"}
    for name, r in ref.items():
        assert got[name].shape == r.shape, name
        if name in ("ind", "cat", "mask"):
            np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                       atol=1e-6, err_msg=name)
    assert got["ind"].dtype == got["cat"].dtype == torch.long
    off_map = (np.abs(boxes[..., :2]) >= 6.4).any(-1)
    assert (off_map & mask).any() and (ref["mask"][off_map] == 0).all()
    assert ref["mask"][:, 0].sum() == 0  # the degenerate footprint
    assert 0 < ref["mask"].sum() < mask.sum() and (ref["hm"] == 1).sum() > 0
    one = tt.centerpoint_targets(
        *(torch.from_numpy(a[1]) for a in _lidar_boxes()), (16, 16), 3, PCR,
        VOXEL)
    np.testing.assert_array_equal(one["hm"].numpy(), got["hm"][1].numpy())


def test_fast_focal_loss_value_and_grad_match_jax():
    _, _, ref_t, _ = _cp_targets()
    rs = np.random.RandomState(5)
    hm = np.clip(1 / (1 + np.exp(-rs.randn(3, 16, 16, 3))), 1e-4,
                 1 - 1e-4).astype(np.float32)
    args = [ref_t[k] for k in ("hm", "ind", "mask", "cat")]
    ref, ref_g = jax.value_and_grad(jl.fast_focal_loss)(
        jnp.asarray(hm), *map(jnp.asarray, args))
    pred = torch.from_numpy(hm).requires_grad_()
    got = tl.fast_focal_loss(pred, torch.from_numpy(args[0]),
                             torch.from_numpy(args[1]).long(),
                             torch.from_numpy(args[2]),
                             torch.from_numpy(args[3]).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-5)


def test_gather_reg_loss_per_channel_value_and_grad_match_jax():
    _, _, ref_t, _ = _cp_targets()
    rs = np.random.RandomState(6)
    out = rs.randn(3, 16, 16, 10).astype(np.float32)
    w = rs.rand(10).astype(np.float32)
    args = [ref_t[k] for k in ("mask", "ind", "anno_box")]
    ref = jl.gather_reg_loss_per_channel(jnp.asarray(out),
                                         *map(jnp.asarray, args))
    ref_g = jax.grad(lambda o: jnp.sum(jl.gather_reg_loss_per_channel(
        o, *map(jnp.asarray, args)) * w))(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_()
    got = tl.gather_reg_loss_per_channel(
        o, torch.from_numpy(args[0]), torch.from_numpy(args[1]).long(),
        torch.from_numpy(args[2]))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (10,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-6)


def test_second_box_encode_matches_jax_and_inverts_decode():
    rs = np.random.RandomState(7)

    def boxes7(n):
        return np.concatenate(
            [rs.uniform(-50, 50, (n, 2)), rs.uniform(-3, 1, (n, 1)),
             rs.uniform(0.3, 6, (n, 3)), rs.uniform(-4, 4, (n, 1))],
            -1).astype(np.float32)

    boxes, anchors = boxes7(40), boxes7(40)
    boxes[0, 3:6] = 0.0  # a padded ground-truth slot: sizes below eps
    ref = np.asarray(jbox.second_box_encode(jnp.asarray(boxes),
                                            jnp.asarray(anchors)))
    got = tbox.second_box_encode(torch.from_numpy(boxes),
                                 torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(ref).all()
    back = tbox.second_box_decode(got[1:], torch.from_numpy(anchors[1:]))
    np.testing.assert_allclose(back.numpy(), boxes[1:], rtol=1e-4, atol=1e-4)


def test_synthetic_lidar_batch_follows_the_train_recipe():
    """``entry.synthetic_lidar_batch`` is the first batch of the
    reference's ``synthetic_points_batches`` (box_dim 9), draw for draw."""
    ref = next(synthetic_points_batches(
        3, PCR, num_points=500, max_gt=64, num_classes=10, num_features=5,
        box_dim=9))
    got = synthetic_lidar_batch(3, PCR, num_points=500)
    assert set(got) == set(ref) - {"step"}
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert got["gt_boxes"].shape == (3, 64, 9)
    assert got["gt_classes"].min() == 1 and got["gt_classes"].max() == 10
