"""The row gather's map backward (K3dx) and the DCN sampler's backward (K1b)
against their plain versions on the card, at small shapes.

This file imports neither JAX nor the JAX package, so that it also runs on
a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Every test needs a CUDA device and skips without one. Inputs are made with
numpy from a seed. Tolerances, err <= atol + rtol * size, where size is the
plain version's sum of absolute terms (dx of K3dx) or the plain value:
- K3dx dx: f32 sums of the same terms in another order (atol 1e-6, rtol
  1e-5); bf16 is that sum rounded once (rtol 2**-8, room for the order
  flipping a rounding); and bit for bit between two calls;
- K1b: dys, dxs, dscale sums of 4*C f32 products in another order (atol
  1e-4, rtol 1e-5), bit for bit between two calls; dx f32 (atol 1e-5, rtol
  1e-5) and bf16 (rtol 2**-8), summed with atomics in no fixed order.
"""

import numpy as np
import pytest
import torch

from minddet_tpu_torch.ops import bilinear as bl
from minddet_tpu_torch.ops import hat_sample as hs

DX_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-6, 2 ** -8)}
TAPS_TOL = {"dys": (1e-4, 1e-5), "dxs": (1e-4, 1e-5), "dscale": (1e-4, 1e-5),
            torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -8)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gather_inputs(seed, b, hw, c, p, dev, dtype):
    rs = np.random.RandomState(seed)
    g = torch.from_numpy(rs.randn(b, p, c).astype(np.float32))
    ci = torch.from_numpy(rs.randint(0, hw, (b, p, 4)).astype(np.int32))
    cw = torch.from_numpy(rs.randn(b, p, 4).astype(np.float32))
    return g.to(dev, dtype), ci.to(dev), cw.to(dev)


def _check_dx(g, ci, cw, hw):
    x = torch.empty(g.shape[0], hw, g.shape[2], dtype=g.dtype,
                    device=g.device)
    got = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
    again = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
    torch.cuda.synchronize()
    assert got.dtype == g.dtype and torch.equal(got, again)
    ref = bl.bilinear_gather_bwd_dx_plain(g.cpu().float(), ci.cpu(),
                                          cw.cpu(), hw)
    size = bl.bilinear_gather_bwd_dx_plain(g.cpu().float().abs(), ci.cpu(),
                                           cw.cpu().abs(), hw)
    atol, rtol = DX_TOL[g.dtype]
    err = (got.cpu().float() - ref).abs()
    assert bool((err <= atol + rtol * size).all()), float(err.max())
    return got.cpu(), ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c,p", [(2, 300, 64, 96), (1, 1, 8, 5),
                                      (3, 1000, 384, 640)])
def test_dx_kernel_matches_plain(cuda, dtype, b, hw, c, p):
    """Random rows, a map that is not a whole number of row tiles, a map of
    one row; every row not read is exactly 0."""
    g, ci, cw = _gather_inputs(0, b, hw, c, p, cuda, dtype)
    got, ref = _check_dx(g, ci, cw, hw)
    untouched = ref.abs().sum(-1) == 0
    assert bool((got[untouched] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_kernel_skips_negative_and_clips_past_the_end(cuda, dtype):
    """ci < 0 adds nothing whatever its weight; ci >= HW adds into the last
    row."""
    g, ci, cw = _gather_inputs(1, 2, 200, 64, 128, cuda, dtype)
    ci[:, ::3, 1] = -1
    ci[:, ::5, 2] = -7
    ci[:, 1::4, 0] = 200
    ci[:, 2::4, 3] = 10 ** 6
    _check_dx(g, ci, cw, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("points", [100, 3000])
def test_dx_kernel_duplicated_rows(cuda, dtype, points):
    """Every point on one row: 4 * P corners in one bucket, beyond the
    sort's capacity at P = 3000 (windows of ascending corner ids)."""
    g, ci, cw = _gather_inputs(2, 2, 64, 32, points, cuda, dtype)
    ci[:] = 17
    ci[1, :, 2:] = 18
    if points == 3000:
        assert 4 * points > bl.gather_bwd_dx_plan(2, 64, 32, points)["cap"]
    _check_dx(g, ci, cw, 64)


def _taps_inputs(seed, b, h, w, c, k, spread, dev, dtype):
    """Stride-1 3x3 DCN coordinates (tap-major (B, K, P), P = h * w) with
    gaussian offsets of ``spread`` pixels."""
    rs = np.random.RandomState(seed)
    p = h * w
    iy = np.repeat(np.arange(h), w).astype(np.float32)
    ix = np.tile(np.arange(w), h).astype(np.float32)
    taps = np.arange(k)
    ys = iy[None, None] - 1 + (taps // 3)[None, :, None] \
        + spread * rs.randn(b, k, p)
    xs = ix[None, None] - 1 + (taps % 3)[None, :, None] \
        + spread * rs.randn(b, k, p)
    sc = rs.rand(b, k, p)
    x = rs.randn(b, h, w, c)
    g = rs.randn(b, p, k * c)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (f32(g).to(dtype), f32(x).to(dtype), f32(ys), f32(xs), f32(sc))


def _check_taps(g, x, ys, xs, sc):
    got = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
    again = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    for a, a2 in zip(got[1:], again[1:]):
        assert torch.equal(a, a2)
    ref = hs.hat_sample_2d_taps_bwd_plain(g.cpu().float(), x.cpu().float(),
                                          ys.cpu(), xs.cpu(), sc.cpu())
    for key, a, r in zip((x.dtype, "dys", "dxs", "dscale"), got, ref):
        atol, rtol = TAPS_TOL[key]
        err = (a.cpu().float() - r).abs()
        assert bool((err <= atol + rtol * r.abs()).all()), (key,
                                                            float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5, 80.0])
def test_taps_bwd_window_edges(cuda, dtype, spread):
    """A map so wide that the window holds 4 of 16 rows: corners on the
    window's edge rows and beyond it (the global fallback), at integer
    coordinates, at spread 1.5 and at spread 80 (most off the map)."""
    b, h, w, c = 2, 16, 1024, 8
    plan = hs.taps_bwd_plan(b, h, w, c, 9, h * w)
    assert 0 < plan["rows"] < h
    _check_taps(*_taps_inputs(3, b, h, w, c, 9, spread, cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(12, 8), (16, 384), (9, 40)])
def test_taps_bwd_whole_map_window(cuda, h, c):
    """Maps whose window holds every row, widths of one, 48 and five
    16-byte vectors (channel chunks of 8 and 32)."""
    _check_taps(*_taps_inputs(4, 2, h, h, c, 9, 1.5, cuda, torch.bfloat16))


@pytest.mark.cuda
def test_taps_bwd_no_window(cuda):
    """A map too wide for one row of the smallest chunk: no window, every
    corner through the global fallback."""
    b, h, w, c = 1, 2, 8000, 8
    assert hs.taps_bwd_plan(b, h, w, c, 9, h * w)["rows"] == 0
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    args = _taps_inputs(5, b, h, w, c, 9, 1.5, cuda, torch.float32)
    hs._taps_bwd_cuda(*args, stats=stats)
    fallback, added = stats.tolist()
    assert added > 0 and fallback == added
    _check_taps(*args)
