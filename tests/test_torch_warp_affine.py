"""The port's affine warp (``data/transforms.py:warp_images`` and
``ops/bilinear.py:bilinear_warp_affine_plain``, the warp kernel's plain
version) against the JAX package's ``warp_images``, on the CPU, where the
reference takes its XLA gather.

Inputs are made with numpy from a seed. Tolerances: images in [0, 1] to
1e-5 absolute (four products summed in another order, and the affines'
last bit where each side builds its own from the same draws); bf16 maps
against the reference in f32 on the same bf16 values, within one bf16
rounding of the f32 sum (2**-8 relative: the port sums in f32 and rounds
once, the reference's XLA gather would sum in bf16); the gradients to 1e-4
(f32 sums of up to 8 products a point, scattered in another order) and,
for the affines, whose gradient sums every output pixel's, 1e-4 relative
plus 1e-3.

Also the kernel's launch plan (``warp_affine_plan``) at the COCO path's
five warp shapes, by width, and its refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_transforms import jax_affine_draws

from minddet_tpu.data import transforms as jt
from minddet_tpu_torch import kernels
from minddet_tpu_torch.data import transforms as tt
from minddet_tpu_torch.ops import bilinear as bl

B, H, W = 3, 40, 52
OUT = (24, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, b=B, h=H, w=W, c=3):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


def _both(images, aff_ref, out_hw, aff_port=None):
    """(reference, port's warp_images, plain version) of one warp."""
    aff_port = aff_ref if aff_port is None else aff_port
    want = np.asarray(jt.warp_images(jnp.asarray(images),
                                     jnp.asarray(aff_ref), out_hw))
    got = tt.warp_images(_t(images), _t(aff_port), out_hw)
    plain = bl.bilinear_warp_affine_plain(_t(images), _t(aff_port), out_hw)
    assert got.shape == plain.shape == want.shape
    return want, got.numpy(), plain.numpy()


def _close(want, *gots, atol=1e-5, rtol=0.0):
    for got in gots:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_train_affines_with_flips():
    """C = 3 under the reference's own train affines: its draws handed to
    the port's ``train_affine_from_draws``, each side warping with its own
    matrices."""
    hw = np.array([[40, 52], [33, 47], [40, 21]], np.int32)
    key = jax.random.PRNGKey(3)
    aff_ref, flip_ref = jt.sample_train_affine(key, jnp.asarray(hw), OUT)
    aff, flip = tt.train_affine_from_draws(_t(hw), OUT,
                                           jax_affine_draws(key, B))
    assert np.array_equal(flip.numpy(), np.asarray(flip_ref))
    assert flip.any() and not flip.all()
    _close(*_both(_images(0), np.asarray(aff_ref), OUT, aff.numpy()))


def test_mosaic_quadrant_affine():
    """The mosaic's top-left quadrant: each whole source image fit into
    [0, cx) x [0, cy) of the output, the rest of the output off the map."""
    hw = np.array([[40, 52], [33, 47], [40, 21]], np.float32)
    out = (36, 44)
    cx, cy = np.array([15.3, 22.0, 19.7]), np.array([14.1, 20.5, 23.9])
    aff = np.zeros((B, 2, 3), np.float32)
    aff[:, 0, 0] = hw[:, 1] / cx
    aff[:, 1, 1] = hw[:, 0] / cy
    want, got, plain = _both(_images(1), aff, out)
    _close(want, got, plain)
    assert (want[:, 30:] == 0).all() and (want[:, :10, :10] > 0).any()


@pytest.mark.parametrize("shift", [0.0, 0.5], ids=["whole", "half"])
def test_eval_translations(shift):
    """The eval warp: the image centred in a larger bucket, moved by whole
    pixels (an exact copy) and by half pixels."""
    out = (48, 64)
    aff = np.array([[[1, 0, -(64 - W) / 2 - shift],
                     [0, 1, -(48 - H) / 2 - shift]]] * B, np.float32)
    images = _images(2)
    want, got, plain = _both(images, aff, out)
    _close(want, got, plain)
    if shift == 0.0:  # whole pixels: the image itself, exactly
        np.testing.assert_array_equal(got[:, 4:44, 6:58], images)
        assert (got[:, :4] == 0).all()


def test_rotated_scaled_affine_with_points_off_the_map():
    rs = np.random.RandomState(5)
    ang = rs.uniform(-0.6, 0.6, B)
    sc = rs.uniform(0.4, 2.5, B)
    aff = np.stack([[[sc[i] * np.cos(ang[i]), -sc[i] * np.sin(ang[i]),
                      rs.uniform(-10, 20)],
                     [sc[i] * np.sin(ang[i]), sc[i] * np.cos(ang[i]),
                      rs.uniform(-10, 20)]] for i in range(B)])
    want, got, plain = _both(_images(4), aff.astype(np.float32), OUT)
    _close(want, got, plain)
    assert (got == 0).any() and (got > 0).any()


def test_binary_bitmaps_at_128_slots():
    """Mask R-CNN's GT bitmaps: 128 slots of 0 / 1 under the image's
    affine with its translation / 4."""
    bits = (np.random.RandomState(6).rand(2, 12, 16, 128) < 0.1).astype(
        np.float32)
    aff = np.array([[[1.25, 0, -1.5], [0, 1.25, 0.75]],
                    [[-0.9, 0, 14.2], [0, 0.9, -0.4]]], np.float32)
    want, got, plain = _both(bits, aff, (10, 13))
    _close(want, got, plain)
    assert 0 < got.max() <= 1 and got.min() >= 0


def test_bf16_maps():
    """A bf16 map (the port's result in bf16, the f32 sum rounded once)
    against the reference in f32 on the same bf16 values."""
    images = torch.from_numpy(_images(7)).to(torch.bfloat16)
    aff = np.array([[[1.3, 0.1, -3.0], [-0.05, 1.2, 2.5]],
                    [[-0.8, 0.0, 40.0], [0.0, 0.8, -2.0]],
                    [[2.0, 0.0, 0.5], [0.0, 2.0, 0.25]]], np.float32)
    want = np.asarray(jt.warp_images(jnp.asarray(images.float().numpy()),
                                     jnp.asarray(aff), OUT))
    for got in (tt.warp_images(images, _t(aff), OUT),
                bl.bilinear_warp_affine_plain(images, _t(aff), OUT)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-5)


def test_the_cpu_routes_agree_and_launch_nothing():
    """With and without a gradient asked, a CPU warp gives the same bits
    (both routes run the plain gather) and counts no launch."""
    images = _t(_images(8))
    aff = _t(np.array([[[1.1, 0.2, -2.0], [-0.1, 0.9, 3.0]]] * B,
                      np.float32))
    kernels.reset_launches()
    plain = tt.warp_images(images, aff, OUT)
    graded = tt.warp_images(images.clone().requires_grad_(), aff, OUT)
    assert graded.requires_grad
    assert torch.equal(plain, graded.detach())
    assert torch.equal(plain, bl.bilinear_warp_affine(images, aff, OUT))
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_gradients_to_the_images_and_the_affines():
    """With a gradient asked, the port's gradients to the images and the
    affines against ``jax.grad`` of the reference's ``warp_images``."""
    rs = np.random.RandomState(9)
    images = rs.randn(2, 14, 18, 3).astype(np.float32)
    aff = np.array([[[1.15, 0.2, -1.5], [-0.1, 0.95, 0.75]],
                    [[-0.7, 0.0, 16.2], [0.05, 0.8, -0.4]]], np.float32)
    out = (12, 20)
    g = rs.randn(2, *out, 3).astype(np.float32)
    ref = jax.grad(lambda x, a: jnp.sum(jt.warp_images(x, a, out)
                                        * jnp.asarray(g)),
                   argnums=(0, 1))(jnp.asarray(images), jnp.asarray(aff))
    t = [_t(images).requires_grad_(), _t(aff).requires_grad_()]
    tt.warp_images(*t, out).backward(_t(g))
    np.testing.assert_allclose(t[0].grad.numpy(), np.asarray(ref[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t[1].grad.numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-3)
    assert np.abs(t[1].grad.numpy()).max() > 1.0


# (B, H, W, C) -> (OH, OW) of the COCO path's warps: the train warp, the
# mosaic's (one of four), the eval warp to its two buckets, the bitmaps
COCO_WARPS = {"train": ((16, 640, 640, 3), (512, 512)),
              "mosaic": ((16, 640, 640, 3), (640, 640)),
              "eval_512x768": ((4, 1024, 1024, 3), (512, 768)),
              "eval_768x768": ((4, 1024, 1024, 3), (768, 768)),
              "bitmaps": ((8, 160, 160, 128), (128, 128))}


@pytest.mark.parametrize("name", sorted(COCO_WARPS))
def test_plan_at_the_coco_warps(name):
    (b, h, w, c), (oh, ow) = COCO_WARPS[name]
    plan = bl.warp_affine_plan(b, h, w, c, oh, ow, torch.float32)
    if c == 128:  # the bitmaps: one thread a 16-byte vector
        assert plan["route"] == "vector" and plan["aligned"]
        assert plan["vectors"] == 32
        assert plan["grid"] == (oh * ow * 32 // 256, b, 1)
    else:
        assert plan["route"] == "pixel" and plan["tile"] == (8, 32)
        assert plan["grid"] == (ow // 32, oh // 8, b)
    assert plan["threads"] == 256


@pytest.mark.parametrize("dtype, c, route", [
    (torch.float32, 4, "pixel"), (torch.float32, 5, "vector"),
    (torch.bfloat16, 8, "pixel"), (torch.bfloat16, 9, "vector")])
def test_plan_route_by_width(dtype, c, route):
    """One 16-byte vector a pixel at most takes the pixel route; wider C
    the vector route, aligned where C is a whole number of vectors."""
    plan = bl.warp_affine_plan(2, 37, 45, c, 20, 40, dtype)
    assert plan["route"] == route
    if route == "vector":
        assert plan["vectors"] == 2 and not plan["aligned"]
    else:
        assert plan["grid"] == (2, 3, 2)


@pytest.mark.parametrize("args, err", [
    ((2, 8, 8, 3, 4, 4, torch.float16), TypeError),
    ((0, 8, 8, 3, 4, 4, torch.float32), ValueError),
    ((2, 8, 8, 0, 4, 4, torch.float32), ValueError),
    ((2, 8, 8, 3, 0, 4, torch.float32), ValueError),
    ((2, 2 ** 24, 8, 3, 4, 4, torch.float32), ValueError),
    ((2, 8, 8, 3, 4, 2 ** 24, torch.float32), ValueError),
    ((65536, 8, 8, 3, 4, 4, torch.float32), ValueError),
    ((1, 8, 8, 3, 8 * 65536, 4, torch.float32), ValueError),
    ((1, 8, 2 ** 23, 128, 4, 4, torch.float32), ValueError),
    ((1, 4, 4, 128, 46341, 46341, torch.float32), ValueError)],
    ids=["f16", "no_image", "no_channel", "no_output", "tall_map",
         "wide_output", "batch_past_grid", "tile_rows_past_grid",
         "row_past_int32", "image_past_2_31_vectors"])
def test_plan_refusals(args, err):
    with pytest.raises(err):
        bl.warp_affine_plan(*args)


def test_affine_points_is_re_exported():
    assert tt.affine_points is bl.affine_points
