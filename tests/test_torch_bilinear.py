"""The port's bilinear row gather and 2D sampling vs the JAX package's, on
the CPU.

``bilinear_gather`` of the port runs its plain version here (f32
accumulation, one rounding). Against the reference's XLA form it agrees to
f32 rounding (1e-5: four products summed in another order); against the
Pallas body in interpret mode to 2e-2, because that body multiplies in bf16
(the tolerance of the reference's own ``tests/test_bilinear.py``).

The backward (``bilinear_gather_bwd_dx_plain`` and ``_dcw_plain``, which the
autograd function runs on the CPU) is compared with ``jax.grad`` of the
reference on its XLA path (f32 sums in another order: 1e-4 on sums of up to
~25 products of N(0, 1) values) and with its Pallas bodies in interpret mode
(bf16 products: 2e-2 relative to the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bilinear import _np_bilinear

from minddet_tpu.ops.bilinear import bilinear_gather as j_gather
from minddet_tpu.ops.bilinear import bilinear_sample_2d as j_sample
from minddet_tpu_torch.ops.bilinear import (bilinear_corners,
                                            bilinear_gather,
                                            bilinear_gather_bwd_dcw,
                                            bilinear_gather_bwd_dcw_plain,
                                            bilinear_gather_bwd_dx,
                                            bilinear_gather_bwd_dx_plain,
                                            bilinear_gather_plain,
                                            bilinear_sample_2d)


def _gather_case(seed, b=2, hw=256, c=128, p=384):
    """Random ``ci`` in [-1, HW), as the reference's interpret-mode test."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, hw, c).astype(np.float32)
    ci = rs.randint(-1, hw, (b, p, 4)).astype(np.int32)
    cw = rs.rand(b, p, 4).astype(np.float32)
    return x, ci, cw


@pytest.mark.parametrize("impl,tol", [("xla", 1e-5), ("pallas", 2e-2)])
def test_gather_matches_jax(impl, tol):
    x, ci, cw = _gather_case(2)
    assert (ci < 0).any()
    ref = np.asarray(j_gather(jnp.asarray(x), jnp.asarray(ci),
                              jnp.asarray(cw), impl, impl == "pallas"),
                     np.float32)
    got = bilinear_gather(torch.from_numpy(x), torch.from_numpy(ci),
                          torch.from_numpy(cw)).numpy()
    assert got.shape == ref.shape == (2, 384, 128)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_gather_skips_on_the_index_not_on_the_weight():
    x = torch.ones(1, 8, 4)
    ci = torch.tensor([[[-1, 0, 1, 2]]], dtype=torch.int32)
    cw = torch.tensor([[[100.0, 1.0, 1.0, 1.0]]])
    np.testing.assert_allclose(bilinear_gather(x, ci, cw).numpy(),
                               np.full((1, 1, 4), 3.0), atol=1e-6)
    # an index past the last row reads the last row, as the clipped gather
    x = torch.arange(8.0).reshape(1, 8, 1).repeat(1, 1, 4)
    ci = torch.tensor([[[9, -1, -1, -1]]], dtype=torch.int32)
    cw = torch.ones(1, 1, 4)
    ref = np.asarray(j_gather(jnp.asarray(x.numpy()), jnp.asarray(ci.numpy()),
                              jnp.asarray(cw.numpy()), "xla"))
    np.testing.assert_array_equal(bilinear_gather(x, ci, cw).numpy(), ref)
    assert ref[0, 0, 0] == 7.0


def test_gather_bf16_rounds_once():
    x, ci, cw = _gather_case(3, c=16, p=64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bilinear_gather(xb, torch.from_numpy(ci), torch.from_numpy(cw))
    assert got.dtype == torch.bfloat16
    exact = bilinear_gather_plain(xb.float(), torch.from_numpy(ci),
                                  torch.from_numpy(cw))
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_sample_2d_matches_jax_and_numpy():
    """Points inside, outside (all four corners dropped), straddling the
    border, and on integer coordinates."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 12, 8).astype(np.float32)
    ys = rs.uniform(-2, 10, (2, 64)).astype(np.float32)
    xs = rs.uniform(-2, 14, (2, 64)).astype(np.float32)
    ys[:, :8] = np.round(ys[:, :8])
    xs[:, 4:12] = np.round(xs[:, 4:12])
    ys[0, 12], xs[0, 12] = 7.0, 11.0      # the last texel, exactly
    ys[0, 13], xs[0, 13] = -1.0, 3.0      # one row above the map
    ys[0, 14], xs[0, 14] = 1e9, -1e9      # far out
    ref = np.asarray(j_sample(jnp.asarray(x), jnp.asarray(ys),
                              jnp.asarray(xs), "xla"))
    got = bilinear_sample_2d(torch.from_numpy(x), torch.from_numpy(ys),
                             torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _np_bilinear(x, ys, xs), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got[0, 12], x[0, 7, 11])
    assert (got[0, 13] == 0).all() and (got[0, 14] == 0).all()
    ci, cw = bilinear_corners(torch.from_numpy(ys), torch.from_numpy(xs), 8,
                              12)
    assert ci.dtype == torch.int32 and (ci[0, 14] == -1).all()
    # the weights stay as they are where the corner is outside the map
    assert (cw[ci < 0] != 0).any()


def test_sample_2d_reads_the_map_in_place():
    """The NHWC view of a channels_last map is taken as it is; any other
    layout raises instead of being copied."""
    rs = np.random.RandomState(1)
    nchw = torch.from_numpy(rs.randn(1, 8, 6, 5).astype(np.float32))
    cl = nchw.contiguous(memory_format=torch.channels_last)
    ys = torch.tensor([[2.5, 0.25]])
    xs = torch.tensor([[1.5, 3.75]])
    got = bilinear_sample_2d(cl.permute(0, 2, 3, 1), ys, xs)
    ref = _np_bilinear(nchw.permute(0, 2, 3, 1).numpy(), ys.numpy(),
                       xs.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        bilinear_sample_2d(nchw.permute(0, 2, 3, 1), ys, xs)


def _jax_grads(x, ci, cw, g, impl):
    f = lambda xv, wv: jnp.sum(j_gather(xv, jnp.asarray(ci), wv, impl,
                                        impl == "pallas") * jnp.asarray(g))
    dx, dcw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cw))
    return np.asarray(dx), np.asarray(dcw)


@pytest.mark.parametrize("impl,tol", [("xla", 1e-4), ("pallas", 2e-2)])
def test_gather_backward_matches_jax(impl, tol):
    """dx and dcw of the autograd function; ``ci`` holds skipped corners
    (-1) and rows hit many times (1536 corners over 256 rows)."""
    x, ci, cw = _gather_case(6)
    g = np.random.RandomState(6).randn(2, 384, 128).astype(np.float32)
    ref_dx, ref_dcw = _jax_grads(x, ci, cw, g, impl)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(cw).requires_grad_()
    bilinear_gather(xt, torch.from_numpy(ci), wt).backward(
        torch.from_numpy(g))
    assert xt.grad.shape == (2, 256, 128) and wt.grad.shape == (2, 384, 4)
    for got, ref in ((xt.grad.numpy(), ref_dx), (wt.grad.numpy(), ref_dcw)):
        scale = 1.0 if impl == "xla" else np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)
    assert (wt.grad.numpy()[ci < 0] == 0).all()
    assert np.abs(ref_dcw[ci >= 0]).min() > 0


def test_gather_backward_skips_and_clips_as_the_forward():
    """A corner with ``ci < 0`` adds nothing to dx whatever its weight and
    gets a zero dcw; an index past the last row adds into, and reads, the
    last row."""
    x = np.arange(32.0, dtype=np.float32).reshape(1, 8, 4)
    ci = np.array([[[-1, 9, 2, 2]]], np.int32)
    cw = np.array([[[100.0, 2.0, 3.0, 4.0]]], np.float32)
    g = np.ones((1, 1, 4), np.float32)
    ref_dx, ref_dcw = _jax_grads(x, ci, cw, g, "xla")
    dx = bilinear_gather_bwd_dx_plain(torch.from_numpy(g),
                                      torch.from_numpy(ci),
                                      torch.from_numpy(cw), 8).numpy()
    dcw = bilinear_gather_bwd_dcw_plain(torch.from_numpy(g),
                                        torch.from_numpy(x),
                                        torch.from_numpy(ci)).numpy()
    np.testing.assert_array_equal(dx, ref_dx)
    np.testing.assert_array_equal(dcw, ref_dcw)
    assert dx[0, 7, 0] == 2.0 and dx[0, 2, 0] == 7.0 and dx.sum() == 36.0
    assert dcw[0, 0].tolist() == [0.0, x[0, 7].sum(), x[0, 2].sum(),
                                  x[0, 2].sum()]


def test_gather_backward_bf16_rounds_once():
    x, ci, cw = _gather_case(7, c=16, p=512)
    g = torch.from_numpy(np.random.RandomState(7).randn(2, 512, 16).astype(
        np.float32)).to(torch.bfloat16)
    cit, cwt = torch.from_numpy(ci), torch.from_numpy(cw)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bilinear_gather_bwd_dx(g, xb, cit, cwt)
    assert got.dtype == torch.bfloat16
    exact = bilinear_gather_bwd_dx_plain(g.float(), cit, cwt, 256)
    assert torch.equal(got, exact.to(torch.bfloat16))
    dcw = bilinear_gather_bwd_dcw(g, xb, cit, cwt)
    assert dcw.dtype == torch.float32
    torch.testing.assert_close(
        dcw, bilinear_gather_bwd_dcw_plain(g.float(), xb.float(), cit))


def test_sample_2d_gradients_match_jax():
    """d/dx, d/dys, d/dxs of ``bilinear_sample_2d`` against ``jax.grad`` on
    the XLA path: points inside, outside and straddling the border (corners
    off the map give the coordinates no gradient). 1e-4: f32 sums of 8
    products."""
    rs = np.random.RandomState(8)
    x = rs.randn(2, 8, 12, 8).astype(np.float32)
    ys = rs.uniform(-2, 10, (2, 64)).astype(np.float32)
    xs = rs.uniform(-2, 14, (2, 64)).astype(np.float32)
    g = rs.randn(2, 64, 8).astype(np.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(j_sample(a, b, c, "xla")
                                           * jnp.asarray(g)),
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(ys),
                                      jnp.asarray(xs))
    t = [torch.from_numpy(a).requires_grad_() for a in (x, ys, xs)]
    bilinear_sample_2d(*t).backward(torch.from_numpy(g))
    for got, r, name in zip(t, ref, ("x", "ys", "xs")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    far = (ys < -1) | (ys > 8) | (xs < -1) | (xs > 12)
    assert far.any() and (t[1].grad.numpy()[far] == 0).all()
    assert np.abs(t[1].grad.numpy()).max() > 0.1


def test_gather_gradcheck_f64():
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(1, 10, 4)).requires_grad_()
    ci = torch.from_numpy(rs.randint(-1, 10, (1, 6, 4)).astype(np.int32))
    cw32 = torch.from_numpy(rs.rand(1, 6, 4).astype(np.float32))
    assert torch.autograd.gradcheck(
        lambda v: bilinear_gather(v, ci, cw32), (x,))


def test_requires_grad_raises_until_the_backward_is_ported():
    """The backward is ported: tensors that require grad differentiate
    through the hand-written backward, and only the gradients asked for
    are computed. (The test keeps the name it had while this call raised,
    so that its record stays one test's; it now checks the routing through
    the autograd function.)"""
    x, ci, cw = _gather_case(4, c=8, p=16)
    xt = torch.from_numpy(x).requires_grad_()
    out = bilinear_gather(xt, torch.from_numpy(ci), torch.from_numpy(cw))
    assert "BilinearGather" in type(out.grad_fn).__name__
    out.sum().backward()
    assert xt.grad is not None and xt.grad.abs().sum() > 0
    wt = torch.from_numpy(cw).requires_grad_()
    out = bilinear_gather(xt.detach(), torch.from_numpy(ci), wt)
    dx, dw = out.grad_fn.apply(torch.ones_like(out))[::2]
    assert dx is None and dw.shape == cw.shape
    with torch.no_grad():
        assert bilinear_gather(xt, torch.from_numpy(ci),
                               torch.from_numpy(cw)).grad_fn is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain(cuda, dtype, tol):
    x, ci, cw = _gather_case(5, c=384, p=2490)
    xt = torch.from_numpy(x).to(cuda, dtype)
    cit, cwt = torch.from_numpy(ci).to(cuda), torch.from_numpy(cw).to(cuda)
    got = bilinear_gather(xt, cit, cwt)
    torch.cuda.synchronize()
    ref = bilinear_gather_plain(xt.float(), cit, cwt)
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_backward_kernels_match_plain(cuda, dtype, tol):
    x, ci, cw = _gather_case(5, c=384, p=640)
    g = torch.from_numpy(np.random.RandomState(5).randn(2, 640, 384).astype(
        np.float32)).to(cuda, dtype)
    xt = torch.from_numpy(x).to(cuda, dtype)
    cit, cwt = torch.from_numpy(ci).to(cuda), torch.from_numpy(cw).to(cuda)
    dx = bilinear_gather_bwd_dx(g, xt, cit, cwt)
    dcw = bilinear_gather_bwd_dcw(g, xt, cit, cwt)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        dx.float(), bilinear_gather_bwd_dx_plain(g.float(), cit, cwt, 256),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        dcw, bilinear_gather_bwd_dcw_plain(g.float(), xt.float(), cit),
        rtol=1e-4, atol=1e-3)


# K3dx's plan at the two-stage CenterPoint train step's shape (bf16 BEV map
# (8, 128 * 128, 384), 640 points) and at one image: 16-row tiles (16 *
# 384 f32 sums = 24 KB), 1024 tiles per image, 20,480 corner ids; None where
# only the properties below are checked
_DX_PLANS = {(8, 16384, 384, 640): dict(tile_rows=16, tiles=8192, cap=1024,
                                        smem_bytes=33_860,
                                        scratch_ints=36_865),
             (1, 16384, 384, 640): dict(tile_rows=16, tiles=1024, cap=1024,
                                        smem_bytes=33_860,
                                        scratch_ints=4609),
             (2, 40000, 256, 10 ** 5): None, (2, 40000, 256, 10 ** 6): None,
             (4, 7, 4, 1): None, (1, 1, 8192, 3): None}


@pytest.mark.parametrize("b,hw,c,p", list(_DX_PLANS))
def test_gather_bwd_dx_plan_sizes(b, hw, c, p):
    """K3dx's launch plan: the expected plan at the main path's shapes;
    everywhere row tiles of a power of two rows whose f32 sums fit the tile
    budget (or one row) and that cover each image's rows once, the bucket
    scratch linear in P (at most 4 ints per corner and 2 per tile, plus
    one), and the sums plus the sort's keys within a block's 227 KB."""
    from minddet_tpu_torch.ops import bilinear as bl

    plan = bl.gather_bwd_dx_plan(b, hw, c, p)
    if _DX_PLANS[(b, hw, c, p)] is not None:
        assert plan == _DX_PLANS[(b, hw, c, p)]
    tq = plan["tile_rows"]
    assert tq & (tq - 1) == 0 and tq <= bl.DX_MAX_TILE_ROWS
    assert tq == 1 or tq * c * 4 <= bl.DX_TILE_BYTES
    per_image, rest = divmod(plan["tiles"], b)
    assert rest == 0 and (per_image - 1) * tq < hw <= per_image * tq
    assert plan["scratch_ints"] <= 4 * b * p + 2 * plan["tiles"] + 1
    assert plan["cap"] >= 512 and plan["cap"] & (plan["cap"] - 1) == 0
    assert tq * c * 4 + plan["cap"] * 8 < plan["smem_bytes"] <= 232_448


def test_gather_bwd_dx_plan_refuses_what_it_cannot_take():
    from minddet_tpu_torch.ops import bilinear as bl

    with pytest.raises(ValueError):
        bl.gather_bwd_dx_plan(4, 100, 8, 2 ** 29)  # corner ids pass 2**31
    with pytest.raises(ValueError):
        bl.gather_bwd_dx_plan(1, 10, 2 ** 16, 5)  # one f32 row too wide


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 5])
def test_pad_channels_keeps_the_plain_results(dtype, c):
    """The kernels' wrappers pad C to 4 (f32) or 8 (bf16) with zeros and
    slice the result back: the plain versions on padded inputs give the
    unpadded results (forward and dx exactly, channel by channel; dcw to
    f32 rounding, its channel sums taking more zero terms)."""
    from minddet_tpu_torch.ops.bilinear import pad_channels

    x, ci, cw = _gather_case(7, c=c, p=96)
    g = np.random.RandomState(8).randn(2, 96, c).astype(np.float32)
    xt, gt = (torch.from_numpy(a).to(dtype) for a in (x, g))
    cit, cwt = torch.from_numpy(ci), torch.from_numpy(cw)
    xp, gp = pad_channels(xt), pad_channels(gt)
    vec = 4 if dtype == torch.float32 else 8
    assert xp.shape[-1] == -(-c // vec) * vec and xp.is_contiguous()
    assert bool((xp[..., c:] == 0).all()) and torch.equal(xp[..., :c], xt)
    assert pad_channels(xp) is xp
    assert torch.equal(bilinear_gather_plain(xp, cit, cwt)[..., :c],
                       bilinear_gather_plain(xt, cit, cwt))
    assert torch.equal(
        bilinear_gather_bwd_dx_plain(gp, cit, cwt, 256)[..., :c],
        bilinear_gather_bwd_dx_plain(gt, cit, cwt, 256))
    torch.testing.assert_close(bilinear_gather_bwd_dcw_plain(gp, xp, cit),
                               bilinear_gather_bwd_dcw_plain(gt, xt, cit),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b, p, c, dtype, fwd_wide, dcw_wide", [
    # Faster R-CNN's box ROIAlign at batch 84: 2.16e9 bf16 output values,
    # past 2**31 (the old refusal) but 2.7e8 vectors, 32-bit threads
    (84, 100_352, 256, torch.bfloat16, False, False),
    # 2**34 output values: 2**31 bf16 vectors, 64-bit threads
    (2048, 8192, 1024, torch.bfloat16, True, False),
    # 2**31 corners of K3dcw: 64-bit warps
    (5350, 100_352, 256, torch.float32, True, True),
])
def test_gather_checks_take_past_2_31_values(b, p, c, dtype, fwd_wide,
                                             dcw_wide):
    """K3f and K3dcw take any B * P * C the reference takes (meta tensors:
    nothing is allocated): the wrappers' checks and launch plans take the
    call as one launch, with 64-bit thread indices from 2**31 vectors (K3f)
    or corners (K3dcw) on; every offset is 64-bit in both kernels."""
    import minddet_tpu_torch.ops.bilinear as tbl

    hw = 128 * 128
    assert b * p * c > 2 ** 31
    x = torch.empty(b, hw, c, dtype=dtype, device="meta")
    ci = torch.empty(b, p, 4, dtype=torch.int32, device="meta")
    cw = torch.empty(b, p, 4, device="meta")
    g = torch.empty(b, p, c, dtype=dtype, device="meta")
    tbl._check(x, ci, cw)
    tbl._check(x, ci, cw, g)
    fwd = tbl.gather_fwd_plan(b, hw, c, p, dtype)
    dcw = tbl.gather_dcw_plan(b, hw, c, p)
    assert fwd["wide"] == fwd_wide and dcw["wide"] == dcw_wide
    assert fwd["blocks"] * tbl.GATHER_THREADS * (
        16 // x.element_size()) >= b * p * c
    assert max(fwd["blocks"], dcw["blocks"]) <= tbl.GRID_BLOCKS


def test_gather_plans_refuse_what_the_grid_cannot_hold():
    import minddet_tpu_torch.ops.bilinear as tbl

    with pytest.raises(ValueError):  # C past the kernel's int argument
        tbl.gather_fwd_plan(1, 16, 2 ** 31, 4, torch.float32)
    with pytest.raises(ValueError):  # more blocks than a grid holds
        tbl.gather_fwd_plan(2 ** 20, 16, 2 ** 12, 2 ** 20, torch.float32)
    with pytest.raises(ValueError):
        tbl.gather_dcw_plan(2 ** 20, 16, 8, 2 ** 20)
