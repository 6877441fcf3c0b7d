"""The port's flat sampler (``hat_sample_2d``, the DCN sampler of layers
whose Cin is not a multiple of 128) vs the JAX package's.

- Forward and gradients through ``hat_sample_2d`` against
  ``minddet_tpu.ops.hat_sample.hat_sample_2d(..., implementation="xla")``
  and ``jax.vjp`` of it: f32 at atol 1e-5 (gradients 1e-4); bf16 within
  one bf16 ulp of the JAX result on the same inputs widened to f32 (the
  port sums in f32 and rounds once; the XLA path in bf16 rounds the sample
  and the scale before their product, so it is not the oracle there).
- ``hat_sample_2d_bwd_plain`` against autograd of ``hat_sample_2d_plain``
  in f64, to f64 rounding.
- The Pallas kernel in interpret mode at 2e-2 away from integer kinks, as
  ``tests/test_hat_sample.py`` holds it (it rounds weights and x to bf16).

Widths C = 3, 12 and 64 (64 is the stage-1 DCN of a ResNet with DCN in
all four stages); coordinates on the integer grid (spread 0, a DCN with
zero offsets), near a raster (1.5 px) and mostly off the map (80 px).
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops import hat_sample as jhs
from minddet_tpu_torch.ops import hat_sample as ths

WIDTHS = (3, 12, 64)
SPREADS = (0.0, 1.5, 80.0)
H, W, N = 8, 10, 600


def _case(c, spread, seed=0, h=H, w=W, n=N):
    rs = np.random.RandomState(seed + c)
    x = rs.randn(2, h, w, c).astype(np.float32)
    if spread == 0.0:  # integer coordinates, a row and column off the map
        ys = rs.randint(-1, h + 1, (2, n)).astype(np.float32)
        xs = rs.randint(-1, w + 1, (2, n)).astype(np.float32)
    else:
        ys = (rs.rand(2, n) * h + rs.randn(2, n) * spread).astype(np.float32)
        xs = (rs.rand(2, n) * w + rs.randn(2, n) * spread).astype(np.float32)
    sc = rs.rand(2, n).astype(np.float32)
    g = rs.randn(2, n, c).astype(np.float32)
    return x, ys, xs, sc, g


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and widened back to f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each value of ``ref``."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _jax_vjp(x, ys, xs, sc, g):
    fn = lambda *a: jhs.hat_sample_2d(*a, implementation="xla")
    args = [jnp.asarray(a) for a in (x, ys, xs, sc) if a is not None]
    if sc is None:
        out, vjp = jax.vjp(lambda *a: fn(*a, None), *args[:3])
    else:
        out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _port_vjp(x, ys, xs, sc, g, dtype):
    args = [torch.from_numpy(x).to(dtype).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (ys, xs)]
    if sc is not None:
        args.append(torch.from_numpy(sc).requires_grad_())
    out = ths.hat_sample_2d(*args[:3], args[3] if sc is not None else None)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g).to(dtype))
    return out, grads


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("spread", SPREADS)
def test_flat_matches_jax_xla_f32(c, spread):
    """f32: forward atol 1e-5, every gradient atol 1e-4 (sums of 4 C
    products in another order); at integer coordinates dys and dxs are the
    XLA path's forward differences, not zero."""
    x, ys, xs, sc, g = _case(c, spread)
    ref, dref = _jax_vjp(x, ys, xs, sc, g)
    out, grads = _port_vjp(x, ys, xs, sc, g, torch.float32)
    assert out.shape == (2, N, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    for name, a, r in zip(("dx", "dys", "dxs", "dscale"), grads, dref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4,
                                   err_msg=name)
    if spread == 0.0:
        assert np.abs(grads[1].numpy()).max() > 0.5
        assert np.abs(grads[2].numpy()).max() > 0.5


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("spread", SPREADS)
def test_flat_matches_jax_xla_bf16(c, spread):
    """bf16 x and g: the output and dx within one bf16 ulp (+ 1e-6 for f32
    sums that cancel) of the JAX result on the bf16 inputs widened to f32
    (f32 sums rounded once); the
    coordinate gradients, f32 on both sides, atol 1e-4."""
    x, ys, xs, sc, g = _case(c, spread, seed=1)
    xw, gw = _bf16(x), _bf16(g)
    ref, dref = _jax_vjp(xw, ys, xs, sc, gw)
    out, grads = _port_vjp(xw, ys, xs, sc, gw, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    for name, a, r in (("out", out.detach(), ref), ("dx", grads[0],
                                                    dref[0])):
        err = np.abs(a.float().numpy() - r)
        assert (err <= _ulp(r) + 1e-6).all(), (name, float(err.max()))
    for name, a, r in zip(("dys", "dxs", "dscale"), grads[1:], dref[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_flat_scale_none():
    """``scale=None`` is scale 1, with no scale gradient, f32 as above."""
    x, ys, xs, _, g = _case(12, 1.5, seed=2)
    ref, dref = _jax_vjp(x, ys, xs, None, g)
    out, grads = _port_vjp(x, ys, xs, None, g, torch.float32)
    assert len(grads) == 3
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    for name, a, r in zip(("dx", "dys", "dxs"), grads, dref):
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4,
                                   err_msg=name)
    bwd = ths.hat_sample_2d_bwd_plain(torch.from_numpy(g),
                                      torch.from_numpy(x),
                                      torch.from_numpy(ys),
                                      torch.from_numpy(xs), None)
    assert bwd[3] is None


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("spread", SPREADS)
def test_flat_bwd_plain_is_autograd_f64(c, spread):
    """The explicit backward equals autograd of the plain forward with an
    f64 x and g: dx to 1e-12 (both f64, products in another order); the
    coordinate gradients, f32 outputs on both sides, within two f32 ulps of
    their largest value (the explicit one sums in f64 and rounds once,
    autograd rounds the weights' gradient to f32 and combines in f32)."""
    x, ys, xs, sc, g = _case(c, spread, seed=3)
    args = [torch.from_numpy(x).double().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (ys, xs, sc)]
    out = ths.hat_sample_2d_plain(*args)
    assert out.dtype == torch.float64
    gd = torch.from_numpy(g).double()
    ref = torch.autograd.grad(out, args, gd)
    got = ths.hat_sample_2d_bwd_plain(gd, *[a.detach() for a in args])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-12, atol=1e-12)
    for name, a, r in zip(("dys", "dxs", "dscale"), got[1:], ref[1:]):
        assert a.dtype == r.dtype == torch.float32
        ulp = float(np.spacing(np.float32(r.abs().max())))
        assert float((a - r).abs().max()) <= 2 * ulp, name


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("spread", [1.5, 80.0])
def test_flat_matches_pallas_interpret(c, spread):
    """The reference's Pallas kernel (interpret mode): the forward at 2e-2,
    each gradient within 2 % of its largest value (sums of C products of
    bf16-rounded factors), with coordinates kept 0.05 px away from
    integers (where its
    hat subgradient differs; see test_reference_pallas_flat_zero_coord_grad
    in test_torch_hat_sample.py). 16x16 map: the kernel needs both sides a
    multiple of 8."""
    x, ys, xs, sc, g = _case(c, spread, seed=4, h=16, w=16)
    ys = np.where(np.abs(ys - np.round(ys)) < 0.05, ys + 0.1, ys)
    xs = np.where(np.abs(xs - np.round(xs)) < 0.05, xs + 0.1, xs)
    ys, xs = ys.astype(np.float32), xs.astype(np.float32)
    fn = lambda *a: jhs.hat_sample_2d(*a, implementation="pallas",
                                      interpret=True)
    ref, vjp = jax.vjp(fn, *map(jnp.asarray, (x, ys, xs, sc)))
    dref = vjp(jnp.asarray(g))
    out, grads = _port_vjp(x, ys, xs, sc, g, torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)
    for name, a, r in zip(("dx", "dys", "dxs", "dscale"), grads, dref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=2e-2 * np.abs(r).max(), err_msg=name)


def test_flat_far_coordinates_contribute_nothing():
    """Coordinates at +-1e6 (the reference's padding) and +-3e9 sample
    nothing and take no gradient, on the plain path as on the card."""
    x, ys, xs, sc, g = _case(12, 1.5, seed=5)
    far = np.array([1e6, -1e6, 3e9, -3e9], np.float32)
    ys[0, :4], xs[1, :4] = far, far
    out, grads = _port_vjp(x, ys, xs, sc, g, torch.float32)
    assert (out[0, :4] == 0).all() and (out[1, :4] == 0).all()
    for d in grads[1:]:
        assert (d[0, :4] == 0).all() and (d[1, :4] == 0).all()
    ref, _ = _jax_vjp(x, ys, xs, sc, g)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_case(c, spread, dev):
    return [torch.from_numpy(a).to(dev)
            for a in _case(c, spread, seed=6, h=32, w=32, n=5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5])
@pytest.mark.parametrize("c", [3, 12, 20, 64])
def test_flat_kernel_matches_plain(cuda, dtype, spread, c):
    """K2f vs its plain version on the card (the same widened inputs): f32
    atol 1e-5; bf16 within one bf16 ulp of the plain f32 result (atol 1e-2
    + rtol 2**-7)."""
    x, ys, xs, sc, _ = _cuda_case(c, spread, cuda)
    got = ths.hat_sample_2d(x.to(dtype), ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_plain(x.to(dtype).float(), ys, xs, sc)
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5])
@pytest.mark.parametrize("c", [3, 12, 20, 64])
def test_flat_bwd_kernel_matches_plain(cuda, dtype, spread, c):
    """K2b vs its plain version on the card: dys, dxs, dscale atol 1e-4 +
    rtol 1e-5 and bit for bit from run to run; dx f32 atol/rtol 1e-5, bf16
    within 2**-8 relative (one rounding) + 1e-5."""
    x, ys, xs, sc, g = _cuda_case(c, spread, cuda)
    x, g = x.to(dtype), g.to(dtype)
    got = ths.hat_sample_2d_bwd(g, x, ys, xs, sc)
    again = ths.hat_sample_2d_bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_bwd_plain(g.float(), x.float(), ys, xs, sc)
    assert got[0].dtype == dtype
    dx_tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
              else dict(rtol=2 ** -8, atol=1e-5))
    torch.testing.assert_close(got[0].float(), ref[0], **dx_tol)
    for a, a2, r in zip(got[1:], again[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-4)
        assert torch.equal(a, a2)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


# K2b's launch plan at stage 1 of the four-stage-DCN ResNet (a 128 x 128 x
# 64 map, 147,456 position-major samples per image): 36 window rows, tiles
# of 1,569 samples (94 per image)
STAGE1 = (128, 128, 64, 128 * 128 * 9)  # H, W, C, N


@pytest.mark.parametrize("b", [1, 16, 128, 256])
def test_flat_bwd_plan_at_stage_one(b):
    """The plan's window, tile and shared memory at the train and serve
    batches: two blocks of at most 110 KB (each with its 1 KB reserve)
    fit in an SM's 227 KB; the tiles cover all N samples of each image;
    the grid stays below 2**31 blocks; C does not enter the plan."""
    h, w, c, n = STAGE1
    plan = ths.flat_bwd_plan(b, h, w, c, n)
    assert (plan["rows"], plan["tile"]) == (36, 1569)
    assert plan["smem_bytes"] == (2 * 36 * 128 + 1) * 4 + 1569 * 48 == 112_180
    assert plan["smem_bytes"] <= 110 * 1024
    assert 2 * (plan["smem_bytes"] + 1024) <= 232_448
    per_image = -(-n // plan["tile"])
    assert per_image == 94 and plan["tiles"] == b * per_image
    assert (per_image - 1) * plan["tile"] < n <= per_image * plan["tile"]
    assert plan["tiles"] < 2 ** 31
    assert plan == ths.flat_bwd_plan(b, h, w, 3, n)


def test_flat_bwd_checks_take_g_past_2_31_values():
    """At batch 256 stage 1's g holds 2.4e9 values, past 2**31: the kernel
    takes 64-bit offsets, so the wrapper's checks and the plan take it in
    one launch (meta tensors: nothing is allocated)."""
    h, w, c, n = STAGE1
    b = 256
    assert b * n * c > 2 ** 31
    x = torch.empty(b, h, w, c, dtype=torch.bfloat16, device="meta")
    ys, xs, sc = (torch.empty(b, n, device="meta") for _ in range(3))
    ths._check(x, ys, xs, sc, 2)
    assert ths.flat_bwd_plan(b, h, w, c, n)["tiles"] == b * 94
    # the forward's plan too: its tiles are counted in 64 bits
    assert ths.flat_fwd_plan(b, h, w, c, n, 2, H100_SMS)["blocks"] == 264


def test_flat_bwd_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        ths.flat_bwd_plan(1, 8, 8, 0, 64)  # no channels
    with pytest.raises(ValueError):
        ths.flat_bwd_plan(1, 8, 8, 3, 2 ** 31)  # N past the kernel's int


H100_SMS = 132  # SMs of an H100 SXM, the card the plans below are for

# K2f's launch plan at stage 1: (rows, tile, tiles, blocks, smem_bytes), bf16,
# on the H100's 132 SMs. A 128 x 64 bf16 map row is 16 KB: 5 rows, beside
# which a tile of 848 samples writes 106 KB (6 rows would leave 394, 50 KB,
# less than the window); at batch 1 a small call, with no window
_FLAT_FWD_PLANS = {1: (0, 559, 264, 264, 20_252),
                   16: (5, 815, 2896, 264, 111_388),
                   128: (5, 843, 22_400, 264, 112_396),
                   256: (5, 848, 44_544, 264, 112_576)}


@pytest.mark.parametrize("b", [1, 16, 128, 256])
def test_flat_fwd_plan_at_stage_one(b):
    """The plan's window, tile, blocks and shared memory at the serve and
    train batches; the tiles cover all N samples of each image in whole
    rounds of the 264 persistent blocks (a small call: one a block)."""
    h, w, c, n = STAGE1
    plan = ths.flat_fwd_plan(b, h, w, c, n, 2, H100_SMS)
    assert (plan["rows"], plan["tile"], plan["tiles"], plan["blocks"],
            plan["smem_bytes"]) == _FLAT_FWD_PLANS[b]
    assert 2 * (plan["smem_bytes"] + 1024) <= 232_448
    per_image = -(-n // plan["tile"])
    assert plan["tiles"] == b * per_image
    assert (per_image - 1) * plan["tile"] < n <= per_image * plan["tile"]
    if plan["rows"]:  # evening out the tiles adds no round of the blocks
        window = -(-(plan["rows"] * w + 1) * c * 2 // 16) * 16
        fit = min(2048, (ths.SMEM_BYTES - window) // 36)
        assert -(-plan["tiles"] // 264) == -(-b * -(-n // fit) // 264)
    else:
        assert plan["tiles"] == 264


def test_flat_fwd_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        ths.flat_fwd_plan(1, 8, 8, 0, 64, 2, H100_SMS)  # no channels
    with pytest.raises(ValueError):
        ths.flat_fwd_plan(1, 8, 8, 3, 2 ** 31, 2, H100_SMS)  # N past the kernel's int
