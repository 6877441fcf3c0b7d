"""Port's modulated bilinear sampler vs the JAX package's.

The port's plain version (``minddet_tpu_torch.ops.hat_sample``) must equal
the JAX XLA path (the corner gather) in f32 to 1e-5: same corners, same f32
weights, scale applied last. Against the Pallas kernel (run in interpret
mode) the tolerance is 2e-2, because that kernel rounds its hat weights and
x to bf16 before its MXU dot. Inputs are made with numpy from a seed.

Gradients follow the XLA path's convention (floor held fixed, so forward
differences at integer coordinates), which the reference's Pallas backward
does not: ``test_reference_pallas_taps_zero_coord_grad_at_integer_coords``
pins that difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops import hat_sample as jhs
from minddet_tpu_torch.ops import hat_sample as ths


def _taps_case(b, h, w, c, p, k, spread, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    # DCN-like: each position's raster point plus noise, per tap
    base_y = np.repeat(np.linspace(0, h - 1, p)[None, None], k, 1)
    base_x = np.tile(np.linspace(0, w - 1, p)[None, None], (1, k, 1))
    ys = (base_y + rs.randn(b, k, p) * spread).astype(np.float32)
    xs = (base_x + rs.randn(b, k, p) * spread).astype(np.float32)
    sc = rs.rand(b, k, p).astype(np.float32)
    return x, ys, xs, sc


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


_CASES = [
    (16, 16, 128, 300, 9, 1.5),   # P not a multiple of 128
    (16, 16, 128, 200, 9, 80.0),  # most samples leave the image
    (64, 64, 128, 700, 9, 1.5),
    (64, 64, 128, 700, 9, 80.0),
]


@pytest.mark.parametrize("h,w,c,p,k,spread", _CASES)
def test_taps_plain_matches_jax_xla(h, w, c, p, k, spread):
    """f32, atol 1e-5: the same arithmetic as the XLA corner gather."""
    x, ys, xs, sc = _taps_case(2, h, w, c, p, k, spread)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(sc),
                                 implementation="xla")
    got = ths.hat_sample_2d_taps(*_port(x, ys, xs, sc))
    assert got.shape == (2, p, k * c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("h,w,c,p,k,spread", _CASES)
def test_taps_plain_matches_pallas_interpret(h, w, c, p, k, spread):
    """atol/rtol 2e-2: the TPU kernel rounds weights and x to bf16."""
    x, ys, xs, sc = _taps_case(2, h, w, c, p, k, spread, seed=1)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(sc),
                                 implementation="pallas", interpret=True)
    got = ths.hat_sample_2d_taps(*_port(x, ys, xs, sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)


def test_taps_scale_none_and_bf16():
    """scale=None is scale 1; a bf16 x gives bf16 out, the f32 result
    rounded once (within one bf16 ulp, rtol 2**-7 + atol 1e-2)."""
    x, ys, xs, _ = _taps_case(1, 16, 16, 128, 130, 9, 1.5, seed=2)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), None, implementation="xla")
    tx, tys, txs = _port(x, ys, xs)
    got = ths.hat_sample_2d_taps(tx, tys, txs, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    got16 = ths.hat_sample_2d_taps(tx.bfloat16(), tys, txs, None)
    assert got16.dtype == torch.bfloat16
    f32 = ths.hat_sample_2d_taps(tx.bfloat16().float(), tys, txs, None)
    np.testing.assert_allclose(got16.float().numpy(), f32.numpy(),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("h,w,c,p,spread", [
    (16, 16, 32, 200, 1.5),
    (8, 16, 8, 130, 80.0),
])
def test_flat_plain_matches_jax_xla(h, w, c, p, spread):
    rs = np.random.RandomState(3)
    x = rs.randn(2, h, w, c).astype(np.float32)
    ys = (rs.rand(2, p) * h + rs.randn(2, p) * spread).astype(np.float32)
    xs = (rs.rand(2, p) * w + rs.randn(2, p) * spread).astype(np.float32)
    sc = rs.rand(2, p).astype(np.float32)
    ref = jhs.hat_sample_2d(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs),
                            jnp.asarray(sc), implementation="xla")
    got = ths.hat_sample_2d(*_port(x, ys, xs, sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sampler_backward_on_cpu():
    """The sampler is differentiable on the CPU through its autograd
    Function, with and without a scale (scale None gets no gradient)."""
    x, ys, xs, sc = _port(*_taps_case(1, 8, 8, 8, 10, 9, 1.0))
    for t in (x, ys, xs, sc):
        t.requires_grad_()
    out = ths.hat_sample_2d_taps(x, ys, xs, sc)
    out.square().sum().backward()
    for t in (x, ys, xs, sc):
        assert t.grad is not None and t.grad.shape == t.shape
        assert t.grad.dtype == torch.float32 and t.grad.abs().sum() > 0
    dx, dys, dxs, dsc = ths.hat_sample_2d_taps_bwd(
        torch.ones_like(out), x.detach(), ys.detach(), xs.detach(), None)
    assert dsc is None and dx.shape == x.shape and dys.shape == ys.shape
    with torch.no_grad():
        ths.hat_sample_2d_taps(x, ys, xs, sc)


def _integer_taps(b, h, w, c, seed=0):
    """A 3x3 DCN's coordinates with zero offsets: every sample on the
    integer grid, as a zero-initialised offset conv gives them."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    iy = np.repeat(np.arange(h), w)[None, None]
    ix = np.tile(np.arange(w), h)[None, None]
    taps = np.arange(9)[None, :, None]
    ys = np.broadcast_to(iy - 1 + taps // 3, (b, 9, h * w)).astype(np.float32)
    xs = np.broadcast_to(ix - 1 + taps % 3, (b, 9, h * w)).astype(np.float32)
    sc = rs.rand(b, 9, h * w).astype(np.float32)
    return x, ys, xs, sc


def _bwd_cases():
    return [
        ("integer", _integer_taps(2, 8, 8, 128, seed=4)),
        ("spread1.5", _taps_case(2, 16, 16, 128, 300, 9, 1.5, seed=5)),
        ("spread80", _taps_case(2, 16, 16, 128, 200, 9, 80.0, seed=6)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["integer", "spread1.5",
                                                "spread80"])
def test_taps_bwd_plain_matches_autograd(case):
    """The explicit backward equals autograd of the plain forward: f32,
    atol 1e-4 (sums of 4*C products in another order; values up to ~60)."""
    _, (x, ys, xs, sc) = _bwd_cases()[case]
    args = [t.requires_grad_() for t in _port(x, ys, xs, sc)]
    out = ths.hat_sample_2d_taps_plain(*args)
    g = torch.from_numpy(np.random.RandomState(7).randn(*out.shape)
                         .astype(np.float32))
    ref = torch.autograd.grad(out, args, g)
    got = ths.hat_sample_2d_taps_bwd_plain(g, *[a.detach() for a in args])
    for name, a, r in zip(("dx", "dys", "dxs", "dscale"), got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-4, msg=name)


@pytest.mark.parametrize("case", range(3), ids=["integer", "spread1.5",
                                                "spread80"])
def test_taps_grads_match_jax_xla(case):
    """The port's backward (through ``hat_sample_2d_taps``) equals
    ``jax.vjp`` of the reference's XLA path, at integer coordinates too:
    f32, atol 1e-4 (values up to ~60, summed in another order)."""
    name, (x, ys, xs, sc) = _bwd_cases()[case]
    fn = lambda *a: jhs.hat_sample_2d_taps(*a, implementation="xla")
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (x, ys, xs, sc)))
    g = np.random.RandomState(8).randn(*out.shape).astype(np.float32)
    ref = vjp(jnp.asarray(g))
    args = [t.requires_grad_() for t in _port(x, ys, xs, sc)]
    got = torch.autograd.grad(ths.hat_sample_2d_taps(*args), args,
                              torch.from_numpy(g))
    for label, a, r in zip(("dx", "dys", "dxs", "dscale"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4, err_msg=label)
    if name == "integer":  # forward differences, not zero
        assert np.abs(got[1].numpy()).max() > 1.0
        assert np.abs(got[2].numpy()).max() > 1.0


def test_reference_pallas_taps_zero_coord_grad_at_integer_coords():
    """Pins a fault of the reference, which the port does not copy: at
    integer coordinates the Pallas backward (``_bwd_taps_kernel``, hat
    subgradient ``sign(r - ys)`` on the open support) returns exactly zero
    coordinate gradients, where the XLA path returns forward differences.
    dx and dscale agree between the two (within the Pallas kernel's bf16
    rounding). 8x8x128, 9 taps, f32, interpret mode."""
    x, ys, xs, sc = _integer_taps(1, 8, 8, 128)
    g = jnp.asarray(np.random.RandomState(5).randn(1, 64, 9 * 128)
                    .astype(np.float32))
    grads = {}
    for impl, kw in (("pallas", dict(interpret=True)), ("xla", {})):
        fn = lambda *a: jhs.hat_sample_2d_taps(*a, implementation=impl, **kw)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, ys, xs, sc)))
        grads[impl] = [np.asarray(t) for t in vjp(g)]
    p_dx, p_dys, p_dxs, p_dsc = grads["pallas"]
    x_dx, x_dys, x_dxs, x_dsc = grads["xla"]
    assert np.abs(p_dys).max() == 0.0 and np.abs(p_dxs).max() == 0.0
    assert np.abs(x_dys).max() > 1.0 and np.abs(x_dxs).max() > 1.0
    np.testing.assert_allclose(p_dx, x_dx, rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(p_dsc, x_dsc, rtol=2e-2, atol=5e-1)


def test_reference_pallas_flat_zero_coord_grad_at_integer_coords():
    """The same fault in the reference's flat kernel (``_bwd_kernel``,
    through ``_factors(grad=True)``), which the port's flat sampler and K2b
    do not copy: at integer coordinates (a 64-channel DCN with zero offsets,
    position-major samples) the Pallas backward returns dys = dxs = 0
    exactly, where the XLA path and the port return forward differences.
    x 1x8x8x64 f32, 576 samples, interpret mode."""
    x, ys, xs, sc = _integer_taps(1, 8, 8, 64, seed=6)
    # position-major (B, P*K), as ops/dcn.py's flat branch lays them out
    flat = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1)).reshape(1, -1)
    ys, xs, sc = flat(ys), flat(xs), flat(sc)
    g = np.random.RandomState(7).randn(1, ys.shape[1], 64).astype(np.float32)
    grads = {}
    for impl, kw in (("pallas", dict(interpret=True)), ("xla", {})):
        fn = lambda *a: jhs.hat_sample_2d(*a, implementation=impl, **kw)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, ys, xs, sc)))
        grads[impl] = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    p_dx, p_dys, p_dxs, p_dsc = grads["pallas"]
    x_dx, x_dys, x_dxs, x_dsc = grads["xla"]
    assert np.abs(p_dys).max() == 0.0 and np.abs(p_dxs).max() == 0.0
    assert np.abs(x_dys).max() > 5.0 and np.abs(x_dxs).max() > 5.0
    args = [t.requires_grad_() for t in _port(x, ys, xs, sc)]
    port = torch.autograd.grad(ths.hat_sample_2d(*args), args,
                               torch.from_numpy(g))
    np.testing.assert_allclose(port[1].numpy(), x_dys, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port[2].numpy(), x_dxs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_dx, x_dx, rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(p_dsc, x_dsc, rtol=2e-2, atol=5e-1)


def test_flat_grads_match_jax_xla():
    """The flat sampler's plain version under autograd equals ``jax.vjp``
    of the reference's XLA path (f32, atol 1e-4)."""
    rs = np.random.RandomState(9)
    x = rs.randn(2, 10, 12, 16).astype(np.float32)
    ys = (rs.rand(2, 150) * 10 + rs.randn(2, 150) * 2).astype(np.float32)
    xs = (rs.rand(2, 150) * 12 + rs.randn(2, 150) * 2).astype(np.float32)
    ys[:, :20] = np.round(ys[:, :20])  # some on the integer grid
    sc = rs.rand(2, 150).astype(np.float32)
    fn = lambda *a: jhs.hat_sample_2d(*a, implementation="xla")
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (x, ys, xs, sc)))
    g = rs.randn(*out.shape).astype(np.float32)
    ref = vjp(jnp.asarray(g))
    args = [t.requires_grad_() for t in _port(x, ys, xs, sc)]
    got = torch.autograd.grad(ths.hat_sample_2d(*args), args,
                              torch.from_numpy(g))
    for label, a, r in zip(("dx", "dys", "dxs", "dscale"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4, err_msg=label)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_taps_kernel_matches_plain(cuda, dtype):
    """Kernel vs plain version on the card: f32 atol 1e-5; bf16 within one
    bf16 ulp of the plain f32 result (atol 1e-2 + rtol 2**-7)."""
    x, ys, xs, sc = _port(*_taps_case(2, 64, 64, 128, 4096, 9, 1.5))
    x, ys, xs, sc = (t.to(cuda) for t in (x, ys, xs, sc))
    got = ths.hat_sample_2d_taps(x.to(dtype), ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_taps_plain(x.to(dtype).float(), ys, xs, sc)
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5])
def test_taps_bwd_kernel_matches_plain(cuda, dtype, spread):
    """Backward kernel vs plain version on the card, the plain version in
    f32 on the same (widened) inputs: dys, dxs, dscale atol 1e-4 + rtol
    1e-5 (f32 sums in atomic order); dx f32 atol/rtol 1e-5, bf16 within
    2**-8 relative (one rounding) + 1e-5."""
    if spread == 0.0:
        x, ys, xs, sc = _integer_taps(2, 64, 64, 128)
    else:
        x, ys, xs, sc = _taps_case(2, 64, 64, 128, 4096, 9, spread)
    g = np.random.RandomState(3).randn(2, ys.shape[2], 9 * 128)
    x, ys, xs, sc, g = (t.to(cuda) for t in _port(x, ys, xs, sc,
                                                  g.astype(np.float32)))
    got = ths.hat_sample_2d_taps_bwd(g.to(dtype), x.to(dtype), ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_taps_bwd_plain(g.to(dtype).float(),
                                           x.to(dtype).float(), ys, xs, sc)
    assert got[0].dtype == dtype
    dx_tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
              else dict(rtol=2 ** -8, atol=1e-5))
    torch.testing.assert_close(got[0].float(), ref[0], **dx_tol)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-4)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.cuda
def test_taps_bwd_kernel_takes_any_width(cuda):
    """K1b at bf16 C = 384 (48 vectors per sample, no power of two), which
    the reference's taps path trains: against the plain version as above,
    and its coordinate gradients bit for bit from run to run."""
    x, ys, xs, sc = _taps_case(2, 16, 16, 384, 256, 9, 1.5)
    g = np.random.RandomState(4).randn(2, 256, 9 * 384).astype(np.float32)
    x, ys, xs, sc, g = (t.to(cuda) for t in _port(x, ys, xs, sc, g))
    x, g = x.bfloat16(), g.bfloat16()
    got = ths.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
    again = ths.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_taps_bwd_plain(g.float(), x.float(), ys, xs, sc)
    torch.testing.assert_close(got[0].float(), ref[0], rtol=2 ** -8,
                               atol=1e-5)
    for a, a2, r in zip(got[1:], again[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-4)
        assert torch.equal(a, a2)


# K1b's launch plan at every main-path shape (H = W, C; the bf16 batch-128
# train step's three DCN inputs, the any-width case), at widths from 8 to
# 2048 and on a map too wide for any window
_PLAN_SHAPES = ([(128, 64, 64, 128), (128, 32, 32, 256), (128, 16, 16, 512),
                 (16, 32, 32, 384)]
                + [(2, 16, 16, c) for c in (8, 16, 24, 40, 64, 136, 1024,
                                            2048)]
                + [(1, 2, 8000, 8), (2, 16, 1024, 8)])


# the expected plan (rows, tile, tiles, smem_bytes) at the train step's
# three shapes, at a map whose window holds 4 of its 16 rows and at one too
# wide for any window
_PLANS = {(128, 64, 64, 128): (64, 179, 2944, 110_100),
          (128, 32, 32, 256): (32, 205, 640, 96_756),
          (128, 16, 16, 512): (16, 128, 256, 57_348),
          (2, 16, 1024, 8): (4, 183, 180, 111_828),
          (1, 2, 8000, 8): (0, 259, 62, 111_892)}


@pytest.mark.parametrize("b,h,w,c", _PLAN_SHAPES)
def test_taps_bwd_plan_fits_and_covers(b, h, w, c):
    """The expected plan at the main-path shapes; everywhere shared memory
    that holds the window (two int32 per texel) and four corner slots of 12
    bytes per sample of the tile, and fits two blocks, each with its 1 KB
    reserve, in 227 KB; window rows within the
    map; tiles that cover every position once. A block takes all C
    channels, so the plan does not depend on C."""
    k, p = 9, h * w
    plan = ths.taps_bwd_plan(b, h, w, c, k, p)
    rows, tile = plan["rows"], plan["tile"]
    if (b, h, w, c) in _PLANS:
        assert (rows, tile, plan["tiles"], plan["smem_bytes"]) == \
            _PLANS[(b, h, w, c)]
    assert plan == ths.taps_bwd_plan(b, h, w, 8, k, p)
    assert plan["smem_bytes"] >= 8 * rows * w + 4 * k * 12 * tile
    assert 2 * (plan["smem_bytes"] + 1024) <= 232_448
    assert 0 <= rows <= h
    per_image = -(-p // tile)
    assert plan["tiles"] == b * per_image
    assert (per_image - 1) * tile < p <= per_image * tile
    if w == 8000:
        assert rows == 0  # not one row fits: every corner is a fallback
    else:
        assert rows >= 1
    if h * w <= 1024:
        assert rows == h  # a small map: the window is the map


def test_taps_bwd_plan_takes_no_positions():
    """P = 0 (an empty batch of positions) plans one empty tile."""
    plan = ths.taps_bwd_plan(2, 8, 8, 16, 9, 0)
    assert plan["tile"] == 1 and plan["tiles"] == 0


def test_taps_bwd_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        ths.taps_bwd_plan(1, 8, 8, 12, 9, 64)  # C % 8 != 0
    with pytest.raises(ValueError):
        ths.taps_bwd_plan(1, 8, 8, 8, 4000, 64)  # one position's corners
