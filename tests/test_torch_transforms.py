"""The port's batched augmentation vs the JAX package's, f32 on the CPU.

Every random transform takes the reference's own draws: the test makes
them with the same ``jax.random.split`` sequence as the reference function
and hands them to the port's ``*_from_draws`` part (torch cannot reproduce
``jax.random``). The ``draw_*`` parts are checked for shapes, ranges and,
for the Beta draw of ``mixup``, its mean and spread.

Tolerances: the affine matrices and the output-space boxes to 1e-5 px
relative plus 1e-4 px (XLA's CPU compile contracts multiply-adds into FMAs
and turns a divide by a constant into a product, so the last bit of a
coordinate may differ); images in [0, 1] to 1e-5 and normalized ones to
5e-5 (the warp is continuous in the sample points, and the colour
augmentation's means sum 10^4 values in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.data import transforms as jt
from minddet_tpu_torch.data import transforms as tt

B, H, W = 3, 40, 52
OUT = (24, 32)
BOX_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed=0, b=B, scale=255.0):
    rs = np.random.RandomState(seed)
    return (rs.rand(b, H, W, 3) * scale).astype(np.float32)


def _hw():
    return np.array([[40, 52], [33, 47], [40, 21]], np.int32)


def _boxes(seed=1, b=B, o=6):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 30, (b, o, 2))
    wh = rs.uniform(2, 20, (b, o, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def jax_affine_draws(key, b):
    """``sample_train_affine``'s draws, as the reference splits its key."""
    r_scale, r_cx, r_cy, r_flip = jax.random.split(key, 4)
    u = jax.random.uniform
    return {"scale": _t(u(r_scale, (b,), minval=0.6, maxval=1.4)),
            "shift_x": _t(u(r_cx, (b,), minval=-0.1, maxval=0.1)),
            "shift_y": _t(u(r_cy, (b,), minval=-0.1, maxval=0.1)),
            "flip": _t(u(r_flip, (b,)) < 0.5)}


def jax_color_draws(key, b):
    """``color_aug``'s draws, as the reference splits its key."""
    r1, r2, r3, r4 = jax.random.split(key, 4)
    u = jax.random.uniform
    return {"brightness": _t(u(r1, (b, 1, 1, 1), minval=-0.4, maxval=0.4)),
            "contrast": _t(u(r2, (b, 1, 1, 1), minval=-0.4, maxval=0.4)),
            "saturation": _t(u(r3, (b, 1, 1, 1), minval=-0.4, maxval=0.4)),
            "lighting": _t(jax.random.normal(r4, (b, 3)))}


def jax_train_transform_draws(key, b):
    """``centernet_train_transform``'s draws."""
    r_aff, r_col = jax.random.split(key)
    return {"affine": jax_affine_draws(r_aff, b),
            "color": jax_color_draws(r_col, b)}


def jax_mosaic_draws(key, b):
    (r_c,) = jax.random.split(key, 1)
    u = jax.random.uniform
    return {"cx": _t(u(r_c, (b,), minval=0.35, maxval=0.65)),
            "cy": _t(u(jax.random.fold_in(r_c, 1), (b,), minval=0.35,
                       maxval=0.65))}


def jax_mixup_draws(key, b, alpha=32.0):
    return {"lam": _t(jax.random.beta(key, alpha, alpha, (b, 1, 1, 1)))}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("flip", [None, (True, False, True)],
                         ids=["plain", "flip"])
def test_affines_match_the_reference(flip):
    rs = np.random.RandomState(2)
    center = rs.uniform(0, 50, (B, 2)).astype(np.float32)
    scale = rs.uniform(20, 80, (B,)).astype(np.float32)
    fl = None if flip is None else np.array(flip)
    want = jt.make_affine(jnp.asarray(center), jnp.asarray(scale), OUT,
                          None if fl is None else jnp.asarray(fl))
    got = tt.make_affine(_t(center), _t(scale), OUT,
                         None if fl is None else _t(fl))
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(tt.invert_affine(got), jt.invert_affine(want), rtol=1e-5,
           atol=1e-5)
    _close(tt.eval_affine(_t(_hw()), OUT), jt.eval_affine(_hw(), OUT),
           rtol=1e-6, atol=1e-6)


def test_sample_train_affine_on_the_reference_draws():
    key = jax.random.PRNGKey(3)
    want, want_flip = jt.sample_train_affine(key, jnp.asarray(_hw()), OUT)
    got, flip = tt.train_affine_from_draws(_t(_hw()), OUT,
                                           jax_affine_draws(key, B))
    np.testing.assert_array_equal(flip.numpy(), np.asarray(want_flip))
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_warp_images_matches_the_reference():
    images = _images(4, scale=1.0)
    rs = np.random.RandomState(5)
    ang = rs.uniform(-0.3, 0.3, B)
    sc = rs.uniform(0.5, 2.0, B)
    aff = np.stack([[[sc[i] * np.cos(ang[i]), -sc[i] * np.sin(ang[i]),
                      rs.uniform(-5, 10)],
                     [sc[i] * np.sin(ang[i]), sc[i] * np.cos(ang[i]),
                      rs.uniform(-5, 10)]] for i in range(B)])
    aff = aff.astype(np.float32)
    want = jt.warp_images(jnp.asarray(images), jnp.asarray(aff), OUT)
    got = tt.warp_images(_t(images), _t(aff), OUT)
    assert got.shape == (B,) + OUT + (3,)
    _close(got, want, rtol=0, atol=1e-5)
    assert (got == 0).any() and (got > 0).any()  # some points off the image


@pytest.mark.parametrize("clip", [True, False])
def test_transform_boxes_matches_the_reference(clip):
    aff, _ = jt.sample_train_affine(jax.random.PRNGKey(6), jnp.asarray(_hw()),
                                    OUT)
    want = jt.transform_boxes(jnp.asarray(_boxes()), aff, OUT, clip=clip)
    got = tt.transform_boxes(_t(_boxes()), _t(aff), OUT, clip=clip)
    _close(got, want, **BOX_TOL)


def test_color_aug_and_normalize_match_the_reference():
    images = _images(7, scale=1.0)
    key = jax.random.PRNGKey(8)
    want = jt.color_aug(key, jnp.asarray(images))
    got = tt.color_aug_from_draws(_t(images), jax_color_draws(key, B))
    _close(got, want, rtol=0, atol=1e-5)
    _close(tt.normalize(_t(images)), jt.normalize(jnp.asarray(images)),
           rtol=0, atol=5e-6)


@pytest.mark.parametrize("out_hw", [OUT, (32, 32)], ids=["wide", "square"])
def test_centernet_train_transform_on_the_reference_draws(out_hw):
    """The reference at its defaults (colour augmentation on), to a wide
    output and to a square one, as the config's 512 x 512."""
    key = jax.random.PRNGKey(9)
    images, hw, boxes = _images(10), _hw(), _boxes(11)
    want = jt.centernet_train_transform(
        key, jnp.asarray(images), jnp.asarray(hw), jnp.asarray(boxes),
        out_hw)
    got = tt.centernet_train_transform_from_draws(
        _t(images), _t(hw), _t(boxes), jax_train_transform_draws(key, B),
        out_hw)
    assert sorted(got) == sorted(want) == ["affine", "boxes", "image"]
    _close(got["affine"], want["affine"], rtol=1e-5, atol=1e-5)
    _close(got["image"], want["image"], rtol=0, atol=5e-5)
    _close(got["boxes"], want["boxes"], **BOX_TOL)


def test_mosaic_and_mixup_on_the_reference_draws():
    b = 4
    images = _images(12, b=b, scale=1.0)
    hw = np.array([[40, 52], [33, 47], [40, 21], [17, 52]], np.int32)
    boxes = _boxes(13, b=b)
    mask = np.random.RandomState(14).rand(b, 6) < 0.7
    key = jax.random.PRNGKey(15)
    out_hw = (36, 44)
    want = jt.mosaic(key, jnp.asarray(images), jnp.asarray(hw),
                     jnp.asarray(boxes), jnp.asarray(mask), out_hw)
    got = tt.mosaic_from_draws(_t(images), _t(hw), _t(boxes), _t(mask),
                               jax_mosaic_draws(key, b), out_hw)
    assert got["image"].shape == (b,) + out_hw + (3,)
    _close(got["image"], want["image"], rtol=0, atol=1e-5)
    _close(got["boxes"], want["boxes"], **BOX_TOL)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    key2 = jax.random.PRNGKey(16)
    want_mx = jt.mixup(key2, want["image"], want["boxes"], want["mask"])
    got_mx = tt.mixup_from_draws(got["image"], got["boxes"], got["mask"],
                                 jax_mixup_draws(key2, b))
    _close(got_mx["image"], want_mx["image"], rtol=0, atol=2e-5)
    _close(got_mx["boxes"], want_mx["boxes"], **BOX_TOL)
    np.testing.assert_array_equal(got_mx["mask"].numpy(),
                                  np.asarray(want_mx["mask"]))


def test_draws_have_the_reference_laws():
    """The draw parts: shapes, dtypes and ranges as the reference draws
    them; Beta(32, 32) through two Gamma draws with its mean 1/2 and its
    std 1 / (2 sqrt(65)) (4096 draws: 3.5 standard errors); the same
    generator state gives the same draws."""
    gen = torch.Generator().manual_seed(0)
    d = tt.draw_train_transform(gen, 5)
    a, c = d["affine"], d["color"]
    assert a["flip"].dtype == torch.bool and a["scale"].shape == (5,)
    assert bool((a["scale"] >= 0.6).all() and (a["scale"] < 1.4).all())
    for k in ("shift_x", "shift_y"):
        assert bool((a[k].abs() <= 0.1).all())
    for k in ("brightness", "contrast", "saturation"):
        assert c[k].shape == (5, 1, 1, 1) and bool((c[k].abs() <= 0.4).all())
    assert c["lighting"].shape == (5, 3)
    m = tt.draw_mosaic(gen, 5)
    assert bool(((m["cx"] >= 0.35) & (m["cx"] < 0.65)).all())
    lam = tt.draw_mixup(gen, 4096)["lam"]
    assert lam.shape == (4096, 1, 1, 1) and lam.dtype == torch.float32
    std = 1 / (2 * np.sqrt(65))
    assert abs(float(lam.mean()) - 0.5) < 3.5 * std / 64
    assert abs(float(lam.std()) - std) < 0.1 * std
    again = tt.draw_train_transform(torch.Generator().manual_seed(0), 5)
    torch.testing.assert_close(again["color"]["lighting"], c["lighting"],
                               rtol=0, atol=0)
