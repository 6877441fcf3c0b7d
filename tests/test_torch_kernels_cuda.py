"""The hand-written kernels redesigned for Hopper against their plain
versions on the card, at small shapes: the row gather's map backward
(K3dx), the DCN samplers' backward (K1b, and K2b, its flat entry) and
forward (K1f, and K2f, its flat entry), the rotated-box intersection (K4),
the row gather's three kernels at widths that are not a whole number of
16-byte vectors, the row gather (K3f) at the R-CNN's ROIAlign shapes,
K3f and K3dcw past 2**31 values, and the segment max (K5f) and its
backward (K5b) at widths that are not a whole number of 16-byte vectors and
past 2**31 values.

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
- K1b and K2b: dys, dxs, dscale sums of 4*C f32 products in another order
  (atol 1e-4, rtol 1e-5), bit for bit between two calls; dx f32 (atol
  1e-5, rtol 1e-5) and bf16 (rtol 2**-8), summed with atomics in no fixed
  order;
- K4: ``IOU_TOL`` of ``chip_smoke.py`` (atol 1e-4, rtol 1e-5: sincosf
  against the CPU's sin and cos, FMA contraction);
- K3f, K3dx, K3dcw at C = 3 and 5: the widths as the plain versions take
  them, at the tolerances of the C % 8 == 0 cases;
- K1f and K2f: f32 within 1e-5 of the plain version (the same products,
  fused or not), bf16 within one bf16 ulp of the plain f32 result (atol
  1e-2 + rtol 2**-7); bit for bit between two calls;
- K3f at the R-CNN shapes: ``GATHER_TOL`` of ``chip_smoke.py`` (f32 atol
  1e-5, rtol 1e-6: four products summed with FMAs; bf16 rtol 2**-8, that
  f32 sum rounded once);
- the affine warp kernel: ``GATHER_TOL`` against its plain version, and
  bit for bit against the route it replaced (``affine_points``,
  ``bilinear_corners``, K3f): widths 1, 3, 4, 5, 128 in f32 and bf16, a
  strong downscale with a rotation, every point off the map, a 1 x 1 map,
  a NaN through a corner of weight 0;
- K5f: exact (max and select only); K5b: ``SEG_BWD_TOL`` of
  ``chip_smoke.py`` (f32 atol and rtol 1e-5, bf16 rtol 2**-7: the kernel
  sums a segment's g row by row, the plain version by shift levels).
"""

import numpy as np
import pytest
import torch

from minddet_tpu_torch import kernels
from minddet_tpu_torch.ops import bilinear as bl
from minddet_tpu_torch.ops import hat_sample as hs
from minddet_tpu_torch.ops import rotated_iou as ri
from minddet_tpu_torch.ops import roi_align as ra
from minddet_tpu_torch.ops import seg_max as sm

DX_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-6, 2 ** -8)}
FWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}
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


def _check_taps(g, x, ys, xs, sc, bwd=hs.hat_sample_2d_taps_bwd,
                plain=hs.hat_sample_2d_taps_bwd_plain):
    got = bwd(g, x, ys, xs, sc)
    again = bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    for a, a2 in zip(got[1:], again[1:]):
        assert torch.equal(a, a2)
    ref = plain(g.cpu().float(), x.cpu().float(), ys.cpu(), xs.cpu(),
                sc.cpu())
    assert got[0].dtype == x.dtype
    for key, a, r in zip((x.dtype, "dys", "dxs", "dscale"), got, ref):
        atol, rtol = TAPS_TOL[key]
        err = (a.cpu().float() - r).abs()
        assert bool((err <= atol + rtol * r.abs()).all()), (key,
                                                            float(err.max()))
    return got


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


def _flat_inputs(seed, b, h, w, c, spread, dev, dtype):
    """The samples of ``_taps_inputs`` position-major, as ``ops/dcn.py``'s
    flat branch lays them out: (B, P * 9) coordinates, g (B, P * 9, C)."""
    g, x, ys, xs, sc = _taps_inputs(seed, b, h, w, c, 9, spread, dev, dtype)
    flat = lambda t: t.transpose(1, 2).reshape(b, -1).contiguous()
    return (g.reshape(b, h * w * 9, c), x, flat(ys), flat(xs), flat(sc))


def _check_flat(*args):
    return _check_taps(*args, bwd=hs.hat_sample_2d_bwd,
                       plain=hs.hat_sample_2d_bwd_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5, 80.0])
def test_flat_bwd_window_edges(cuda, dtype, spread):
    """K2b on a map so wide that the window holds 4 of 16 rows: corners on
    the window's edge rows and beyond it (the global fallback), at integer
    coordinates (forward differences, not zero), at spread 1.5 and at
    spread 80 (most off the map)."""
    b, h, w, c = 2, 16, 1024, 8
    plan = hs.flat_bwd_plan(b, h, w, c, h * w * 9)
    assert 0 < plan["rows"] < h
    got = _check_flat(*_flat_inputs(3, b, h, w, c, spread, cuda, dtype))
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 12, 20, 64])
def test_flat_bwd_widths(cuda, dtype, c):
    """K2b at any width: C = 3 and 20 take one channel per lane step in
    both types, 12 in bf16 too (f32 moves it in 16-byte vectors), 64 (the
    four-stage-DCN ResNet's stage 1) vectors in both."""
    _check_flat(*_flat_inputs(4, 2, 12, 12, c, 1.5, cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_bwd_unaligned_rows(cuda, dtype):
    """g and x that start 2 bytes past a 16-byte boundary (views into a
    larger buffer): one channel per lane step at C = 64."""
    g, x, ys, xs, sc = _flat_inputs(5, 2, 12, 12, 64, 1.5, cuda, dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    g, x = shifted(g), shifted(x)
    assert g.data_ptr() % 16 and x.data_ptr() % 16
    _check_flat(g, x, ys, xs, sc)


@pytest.mark.cuda
def test_flat_bwd_no_window(cuda):
    """A map too wide for one window row: every corner on the map takes
    the global fallback."""
    b, h, w, c = 1, 2, 8000, 8
    n = h * w * 9
    assert hs.flat_bwd_plan(b, h, w, c, n)["rows"] == 0
    args = _flat_inputs(6, b, h, w, c, 1.5, cuda, torch.float32)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    hs._flat_bwd_cuda(*args, stats=stats)
    fallback, added = stats.tolist()
    assert added > 0 and fallback == added
    _check_flat(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_bwd_far_coordinates(cuda, dtype):
    """Samples at +-1e6, +-3e9 and NaN add nothing to dx (it matches the
    plain version with the NaN moved to 1e6); the far ones get zero dys,
    dxs and dscale, the NaN ones 0 or NaN (a NaN weight times a zero dot);
    the rest match the plain version, bit for bit between two calls."""
    g, x, ys, xs, sc = _flat_inputs(7, 2, 16, 16, 12, 1.5, cuda, dtype)
    far = torch.tensor([1e6, -1e6, 3e9, -3e9, float("nan")], device=cuda)
    ys[0, :5] = far
    xs[1, :5] = far
    got = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
    again = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    ys[0, 4] = xs[1, 4] = 1e6
    ref = hs.hat_sample_2d_bwd_plain(g.cpu().float(), x.cpu().float(),
                                     ys.cpu(), xs.cpu(), sc.cpu())
    keep = torch.ones(ys.shape[1], dtype=torch.bool)
    keep[4] = False
    for key, a, a2, r in zip((dtype, "dys", "dxs", "dscale"), got, again,
                             ref):
        a, a2 = a.cpu().float(), a2.cpu().float()
        if key != dtype:
            nan_sample = a[:, 4]
            assert bool((nan_sample.isnan() | (nan_sample == 0)).all())
            a, a2, r = a[:, keep], a2[:, keep], r[:, keep]
            assert torch.equal(a, a2) and bool((a[:, :4] == 0).all())
        atol, rtol = TAPS_TOL[key]
        assert bool(((a - r).abs() <= atol + rtol * r.abs()).all()), key


@pytest.mark.cuda
def test_flat_bwd_past_2_31_values(cuda):
    """A g of more than 2**31 values (bf16, C = 8, one image): only the
    last 4,096 samples, whose g rows lie past 2**31 values, are on the map
    and have a non-zero g, so a 32-bit offset would read zeros there. dx
    and their coordinate gradients match the plain version on those
    samples alone; every other sample gets exactly 0."""
    c, tail = 8, 4096
    n = 2 ** 31 // c + tail
    free, _ = torch.cuda.mem_get_info()
    if free < 20 * 2 ** 30:
        pytest.skip("needs ~20 GB of free device memory")
    g_t, x, ys_t, xs_t, sc_t = _flat_inputs(8, 1, 32, 32, c, 1.5, cuda,
                                            torch.bfloat16)
    g_t, ys_t, xs_t, sc_t = (t[:, :tail] for t in (g_t, ys_t, xs_t, sc_t))
    g = torch.zeros(1, n, c, dtype=torch.bfloat16, device=cuda)
    g[:, -tail:] = g_t
    ys = torch.full((1, n), 1e6, device=cuda)
    ys[:, -tail:] = ys_t
    xs = torch.zeros(1, n, device=cuda)
    xs[:, -tail:] = xs_t
    sc = torch.ones(1, n, device=cuda)
    sc[:, -tail:] = sc_t
    assert (n - tail) * c > 2 ** 31 - 1  # the tail's g lies past int32
    dx, dys, dxs, dsc = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
    torch.cuda.synchronize()
    del g
    ref = hs.hat_sample_2d_bwd_plain(g_t.cpu().float(), x.cpu().float(),
                                     ys_t.cpu(), xs_t.cpu(), sc_t.cpu())
    atol, rtol = TAPS_TOL[torch.bfloat16]
    assert bool(((dx.cpu().float() - ref[0]).abs()
                 <= atol + rtol * ref[0].abs()).all())
    for key, d, r in zip(("dys", "dxs", "dscale"), (dys, dxs, dsc), ref[1:]):
        assert bool((d[:, :-tail] == 0).all())
        atol, rtol = TAPS_TOL[key]
        err = (d[:, -tail:].cpu() - r).abs()
        assert bool((err <= atol + rtol * r.abs()).all()), key
    assert dys[:, -tail:].abs().max() > 0


def _same_bits(a, b):
    """Equal bit for bit, NaN included."""
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.view(bits), b.view(bits))


def _check_fwd(x, ys, xs, sc, fwd=hs.hat_sample_2d_taps,
               plain=hs.hat_sample_2d_taps_plain):
    got = fwd(x, ys, xs, sc)
    again = fwd(x, ys, xs, sc)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and _same_bits(got, again)
    ref = plain(x.cpu().float(), ys.cpu(), xs.cpu(), sc.cpu())
    atol, rtol = FWD_TOL[x.dtype]
    err = (got.cpu().float() - ref).abs()
    assert bool((err <= atol + rtol * ref.abs()).all()), float(err.max())
    return got


def _fwd_stats(fn, *args, **kw):
    """(corners on the map read from global memory, all corners on the
    map) of one launch."""
    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    fn(*args, stats=stats, **kw)
    return stats.tolist()


def _one_sm(x, ys, xs, sc, stats=None):
    """The forward (tap-grouped for 3-d coordinates, flat for 2-d) launched
    with the plan for a card of one SM, which keeps a window for calls as
    small as these (on the H100 a call of fewer than two tiles a block gets
    none)."""
    b, h, w, c = x.shape
    elt, code = x.element_size(), 0 if x.dtype == torch.float32 else 1
    stats_ptr = 0 if stats is None else stats.data_ptr()
    stream = kernels.cuda_stream(x.device)
    args = (x.data_ptr(), ys.data_ptr(), xs.data_ptr(), sc.data_ptr())
    if ys.dim() == 3:
        k, p = ys.shape[1:]
        plan = hs.taps_fwd_plan(b, h, w, c, k, p, elt, 1)
        out = torch.empty(b, p, k * c, dtype=x.dtype, device=x.device)
        err = kernels.HAT_SAMPLE_TAPS_FWD.fn()(
            *args, out.data_ptr(), stats_ptr, b, h, w, c, k, p, plan["tile"],
            plan["rows"], plan["blocks"], code, stream)
    else:
        n = ys.shape[1]
        plan = hs.flat_fwd_plan(b, h, w, c, n, elt, 1)
        out = torch.empty(b, n, c, dtype=x.dtype, device=x.device)
        err = kernels.HAT_SAMPLE_FLAT_FWD.fn()(
            *args, out.data_ptr(), stats_ptr, b, h, w, c, n, plan["tile"],
            plan["rows"], plan["blocks"], code, hs._vec(c, x, out), stream)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [0.0, 1.5, 80.0])
def test_taps_fwd_window_edges(cuda, dtype, spread):
    """K1f on a map so wide that the window holds 2 (bf16) or 1 (f32) of
    16 rows: tiles on the map's first and last rows, whose windows are
    clamped at its edges, a ring that keeps rows from tile to tile,
    corners beyond the window (the global fallback), at integer
    coordinates, at spread 1.5 and at spread 80 (most off the map)."""
    b, h, w, c = 2, 16, 1024, 8
    _, x, ys, xs, sc = _taps_inputs(14, b, h, w, c, 9, spread, cuda, dtype)
    plan = hs.taps_fwd_plan(b, h, w, c, 9, h * w, x.element_size(), 1)
    assert 0 < plan["rows"] < h
    _check_fwd(x, ys, xs, sc, fwd=_one_sm)
    fallback, onmap = _fwd_stats(_one_sm, x, ys, xs, sc)
    assert 0 < fallback <= onmap


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(12, 8), (8, 384), (9, 40)])
def test_taps_fwd_whole_map_window(cuda, h, c):
    """Maps whose window holds every row, widths of one, 48 and five
    16-byte vectors: no corner takes the fallback."""
    _, x, ys, xs, sc = _taps_inputs(15, 4, h, h, c, 9, 1.5, cuda,
                                    torch.bfloat16)
    assert hs.taps_fwd_plan(4, h, h, c, 9, h * h, 2, 1)["rows"] == h
    _check_fwd(x, ys, xs, sc, fwd=_one_sm)
    fallback, onmap = _fwd_stats(_one_sm, x, ys, xs, sc)
    assert onmap > 0 and fallback == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_taps_fwd_no_window(cuda, dtype):
    """A map too wide for one window row, and the same call on the card as
    it is (a small call): every corner on the map takes the global
    fallback."""
    b, h, w, c = 1, 2, 8000, 8
    _, x, ys, xs, sc = _taps_inputs(16, b, h, w, c, 9, 1.5, cuda, dtype)
    assert hs.taps_fwd_plan(b, h, w, c, 9, h * w, x.element_size(),
                            1)["rows"] == 0
    for fwd in (_one_sm, hs._taps_cuda):
        _check_fwd(x, ys, xs, sc, fwd=fwd)
        fallback, onmap = _fwd_stats(fwd, x, ys, xs, sc)
        assert onmap > 0 and fallback == onmap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(16, 64), (16, 128), (8, 512)])
def test_taps_fwd_small_call_widths(cuda, dtype, h, c):
    """Batch-1 calls on the card as it is (no window): samples of 8 to 128
    16-byte vectors, on both sides of the 16 at which the sweep without a
    window takes four vectors a unit instead of two units of two."""
    _, x, ys, xs, sc = _taps_inputs(21, 1, h, h, c, 9, 1.5, cuda, dtype)
    plan = hs.taps_fwd_plan(1, h, h, c, 9, h * h, x.element_size(),
                            hs._sms(x.device))
    assert plan["rows"] == 0
    _check_fwd(x, ys, xs, sc)
    fallback, onmap = _fwd_stats(hs._taps_cuda, x, ys, xs, sc)
    assert onmap > 0 and fallback == onmap


def _check_flat_fwd(x, ys, xs, sc, one_sm=False):
    return _check_fwd(x, ys, xs, sc, fwd=_one_sm if one_sm else
                      hs.hat_sample_2d, plain=hs.hat_sample_2d_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 5, 12, 20, 24, 64])
@pytest.mark.parametrize("one_sm", [False, True])
def test_flat_fwd_widths(cuda, dtype, c, one_sm):
    """K2f at widths 3 to 64: one channel per lane step where C is not a
    whole number of 16-byte vectors (3, 5, 20 in both types, 12 in bf16),
    vectors otherwise; on a 40 x 40 map, planned for the card as it is
    (no window: a small call) and for one SM (a window of some or all of
    its rows)."""
    _, x, ys, xs, sc = _flat_inputs(17, 2, 40, 40, c, 1.5, cuda, dtype)
    if one_sm:
        assert hs.flat_fwd_plan(2, 40, 40, c, 40 * 40 * 9, x.element_size(),
                                1)["rows"] > 0
    _check_flat_fwd(x, ys, xs, sc, one_sm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_fwd_unaligned_rows(cuda, dtype):
    """x that starts 2 bytes past a 16-byte boundary (a view into a larger
    buffer): one channel per lane step at C = 64, the window copied by the
    threads instead of the bulk copy (planned for one SM, so that there is
    a window)."""
    _, x, ys, xs, sc = _flat_inputs(18, 4, 12, 12, 64, 1.5, cuda, dtype)
    assert hs.flat_fwd_plan(4, 12, 12, 64, 12 * 12 * 9, x.element_size(),
                            1)["rows"] == 12
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    _check_flat_fwd(shifted, ys, xs, sc, one_sm=True)


@pytest.mark.cuda
@pytest.mark.parametrize("one_sm", [False, True])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_far_coordinates(cuda, flat, dtype, one_sm):
    """Samples at +-1e6, +-3e9, +-inf and NaN give exactly 0; the rest
    match the plain version (which gives NaN for a non-finite coordinate:
    it is held to the same samples moved to 1e6). Planned for the card as
    it is (no window) and for one SM (the whole map in the window)."""
    if flat:
        _, x, ys, xs, sc = _flat_inputs(19, 4, 16, 16, 16, 1.5, cuda, dtype)
    else:
        _, x, ys, xs, sc = _taps_inputs(19, 4, 16, 16, 16, 9, 1.5, cuda,
                                        dtype)
    far = torch.tensor([1e6, -1e6, 3e9, -3e9, float("inf"), -float("inf"),
                        float("nan")], device=cuda)
    m = len(far)
    if flat:
        ys[0, :m] = far
        xs[1, :m] = far
        fwd, plain = hs._flat_cuda, hs.hat_sample_2d_plain
    else:
        ys[0, 0, :m] = far
        xs[1, 4, :m] = far
        fwd, plain = hs._taps_cuda, hs.hat_sample_2d_taps_plain
    if one_sm:
        fwd = _one_sm
    got = fwd(x, ys, xs, sc)
    again = fwd(x, ys, xs, sc)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    c = x.shape[3]
    if flat:
        assert bool((got[:2, :m] == 0).all())
    else:
        assert bool((got[0, :m, :c] == 0).all())
        assert bool((got[1, :m, 4 * c:5 * c] == 0).all())
    fix = lambda t: torch.where(t.isfinite(), t, torch.full_like(t, 1e6))
    ref = plain(x.cpu().float(), fix(ys).cpu(), fix(xs).cpu(), sc.cpu())
    atol, rtol = FWD_TOL[dtype]
    assert bool(((got.cpu().float() - ref).abs()
                 <= atol + rtol * ref.abs()).all())


@pytest.mark.cuda
def test_taps_fwd_past_2_31_values(cuda):
    """K1f writing more than 2**31 values in one launch (bf16, C = 8, nine
    taps, one image): only the last 512 positions are on the map, and their
    output lies past 2**31 values, so a 32-bit offset would write it
    elsewhere. Those positions match the plain version; every other output
    value is exactly 0."""
    c, k, tail = 8, 9, 512
    p = -(-2 ** 31 // (k * c)) + tail
    free, _ = torch.cuda.mem_get_info()
    if free < 12 * 2 ** 30:
        pytest.skip("needs ~12 GB of free device memory")
    _, x, ys_t, xs_t, sc_t = _taps_inputs(20, 1, 16, 32, c, k, 1.5, cuda,
                                          torch.bfloat16)
    ys_t, xs_t, sc_t = (t[:, :, :tail] for t in (ys_t, xs_t, sc_t))
    ys = torch.full((1, k, p), 1e6, device=cuda)
    ys[:, :, -tail:] = ys_t
    xs = torch.zeros(1, k, p, device=cuda)
    xs[:, :, -tail:] = xs_t
    sc = torch.ones(1, k, p, device=cuda)
    sc[:, :, -tail:] = sc_t
    assert (p - tail) * k * c > 2 ** 31 - 1  # the tail's output past int32
    out = hs.hat_sample_2d_taps(x, ys, xs, sc)
    torch.cuda.synchronize()
    del ys, xs, sc
    assert not bool(out[:, :-tail].any())
    ref = hs.hat_sample_2d_taps_plain(x.cpu().float(), ys_t.cpu(),
                                      xs_t.cpu(), sc_t.cpu())
    atol, rtol = FWD_TOL[torch.bfloat16]
    got = out[:, -tail:].cpu().float()
    assert bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())
    assert ref.abs().max() > 0


IOU_TOL = dict(atol=1e-4, rtol=1e-5)


def _car(rs, n):
    return 1.6 * np.exp(0.1 * rs.randn(n)), 3.9 * np.exp(0.1 * rs.randn(n))


def _check_iou(b1, b2, dev):
    t1 = torch.from_numpy(np.asarray(b1, np.float32)).to(dev)
    t2 = torch.from_numpy(np.asarray(b2, np.float32)).to(dev)
    got = ri.rotated_intersection_bev(t1, t2)
    torch.cuda.synchronize()
    ref = ri.rotated_intersection_bev_plain(t1.cpu(), t2.cpu())
    torch.testing.assert_close(got.cpu(), ref, **IOU_TOL)
    # the separation test settles pairs at exactly 0
    sep = ri.separated(t1, t2).cpu()
    assert bool((got.cpu()[sep] == 0).all())
    return got.cpu(), ref, sep


@pytest.mark.cuda
def test_iou_near_touching_pairs(cuda):
    """K4 on pairs ~70 m out that nearly touch: circumscribed circles 0 to
    1e-3 m apart with corners pointing at each other, edges 1e-3 m apart
    to 1e-3 m overlapped, identical and contained boxes; the whole (1, 400,
    400) matrix of them."""
    rs = np.random.RandomState(9)
    q = 100
    w, l = _car(rs, 4 * q)
    a = np.stack([rs.uniform(60, 70, 4 * q), rs.uniform(-10, 10, 4 * q), w,
                  l, rs.uniform(-np.pi, np.pi, 4 * q)], -1)
    b = a.copy()
    phi = rs.uniform(-np.pi, np.pi, q)
    wb, lb = _car(rs, q)
    reach = (0.5 * (np.hypot(w[:q], l[:q]) + np.hypot(wb, lb))
             + np.concatenate([[0.0], 10 ** rs.uniform(-7, -3, q - 1)]))
    a[:q, 4] = phi - np.arctan2(l[:q], w[:q])
    b[:q] = np.stack([a[:q, 0] + reach * np.cos(phi),
                      a[:q, 1] + reach * np.sin(phi), wb, lb,
                      phi + np.pi - np.arctan2(lb, wb)], -1)
    e = slice(q, 2 * q)
    wb, lb = _car(rs, q)
    step = 0.5 * (w[e] + wb) + rs.uniform(-1e-3, 1e-3, q)
    b[e] = np.stack([a[e, 0] + step * np.cos(a[e, 4]),
                     a[e, 1] + step * np.sin(a[e, 4]), wb, lb, a[e, 4]], -1)
    b[3 * q:, 2:4] *= 0.5
    b[3 * q:, :2] += rs.uniform(-0.2, 0.2, (q, 2))
    got, ref, sep = _check_iou(a[None], b[None], cuda)
    assert bool(torch.diagonal(sep[0])[:q].any())  # some circles apart
    assert bool((torch.diagonal(ref[0])[2 * q:] > 0).all())


@pytest.mark.cuda
def test_iou_dense_clusters(cuda):
    """900 candidates in 5 tight clusters (centres N(c, 1 m)): ~20 % of
    the pairs left to the clip, up to a quarter of some blocks."""
    rs = np.random.RandomState(10)
    n = 900
    centres = np.stack([rs.uniform(20, 60, 5), rs.uniform(-30, 30, 5)], -1)
    which = np.arange(n) % 5
    w, l = _car(rs, n)
    yaw = (rs.uniform(-np.pi, np.pi, 5)[which] + 0.1 * rs.randn(n)
           + np.pi * (rs.rand(n) < 1 / 3))
    xy = centres[which] + rs.randn(n, 2)
    boxes = np.concatenate([xy, np.stack([w, l, yaw], -1)], -1)[None]
    got, ref, sep = _check_iou(boxes, boxes, cuda)
    assert 0.1 < float((~sep).float().mean()) < 0.3


@pytest.mark.cuda
def test_iou_zero_size_boxes(cuda):
    """Zero-size boxes (a padded ground-truth slot, all zeros) on either
    side: as boxes1 every area is exactly 0; as boxes2 the clip keeps all
    of box1 (its edges clip nothing) and the separation test must not
    settle them."""
    rs = np.random.RandomState(11)
    w, l = _car(rs, 64)
    props = np.stack([rs.uniform(0, 50, 64), rs.uniform(-20, 20, 64), w, l,
                      rs.uniform(-np.pi, np.pi, 64)], -1)
    slots = props[:32].copy()
    slots[16:] = 0.0
    got, ref, sep = _check_iou(props[None], slots[None], cuda)
    assert not bool(sep[0, :, 16:].any())
    torch.testing.assert_close(got[0, :, 16:],
                               torch.from_numpy((w * l)[:, None].astype(
                                   np.float32)).expand(-1, 16), **IOU_TOL)
    got, _, _ = _check_iou(slots[None], props[None], cuda)
    assert bool((got[0, 16:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 5])
def test_gather_kernels_take_any_width(cuda, dtype, c):
    """K3f, K3dx and K3dcw at C = 3 and 5: the wrappers pad the channels to
    a 16-byte vector and slice the padding off; against the plain versions
    at the widths as given."""
    g, ci, cw = _gather_inputs(12, 2, 300, c, 96, cuda, dtype)
    x = torch.from_numpy(np.random.RandomState(13).randn(2, 300, c).astype(
        np.float32)).to(cuda, dtype)
    ci[:, ::7, 1] = -1
    out = bl.bilinear_gather(x, ci, cw)
    dcw = bl.bilinear_gather_bwd_dcw(g, x, ci, cw)
    torch.cuda.synchronize()
    assert out.shape == (2, 96, c) and out.is_contiguous()
    ref = bl.bilinear_gather_plain(x.float(), ci, cw)
    tol = ((1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2 ** -8))
    assert bool(((out.float() - ref).abs()
                 <= tol[0] + tol[1] * ref.abs()).all())
    torch.testing.assert_close(
        dcw, bl.bilinear_gather_bwd_dcw_plain(g.float(), x.float(), ci),
        rtol=1e-5, atol=1e-4)
    got, _ = _check_dx(g, ci, cw, 300)
    assert got.shape == (2, 300, c)


def _report(kernel, size, got, ref):
    """Print the tail's largest absolute and relative error (run with
    ``-s`` to read them)."""
    err = (got.float() - ref).abs()
    rel = (err / ref.abs())[ref != 0]
    print(f"\n{kernel} at {size} values: max_abs_err={float(err.max()):.3e}"
          f" max_rel_err={float(rel.max()):.3e}")


def _gather_tail_case(dev, b, p, c, dtype, tail, seed):
    """(x, ci, cw, tail points): a (b, 64, c) map; every point skips all
    four corners (ci = -1) but the last ``tail`` of the last image, which
    sample the map at random."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, 64, c).astype(np.float32)).to(dev, dtype)
    ci = torch.full((b, p, 4), -1, dtype=torch.int32, device=dev)
    cw = torch.ones(b, p, 4, device=dev)
    ci_t = torch.from_numpy(rs.randint(0, 64, (tail, 4)).astype(np.int32))
    cw_t = torch.from_numpy(rs.rand(tail, 4).astype(np.float32))
    ci[-1, -tail:] = ci_t.to(dev)
    cw[-1, -tail:] = cw_t.to(dev)
    return x, ci, cw, ci_t, cw_t


@pytest.mark.cuda
@pytest.mark.parametrize("b, p, c, wide", [
    # 2**31 + 2**20 bf16 output values, 32-bit thread indices (the old
    # wrapper refused this: the box ROIAlign past batch 83)
    (2, 2 ** 22 + 2 ** 11, 256, False),
    # 2**31 + 2**20 bf16 output vectors (2**34 + 2**23 values, 34 GB):
    # 64-bit thread indices, the tail's past 2**31
    (1, 2 ** 21 + 2 ** 10, 8192, True),
])
def test_gather_fwd_past_2_31_values(cuda, b, p, c, wide):
    """K3f writing more than 2**31 values in one launch: only the last 512
    points of the last image are on the map, and their rows lie past 2**31
    values (and, in the second case, past 2**31 threads), so a 32-bit
    offset would write them elsewhere. They match the plain version; every
    other output value is exactly 0."""
    tail = 512
    need = b * p * c * 2 + b * p * 32
    torch.cuda.empty_cache()  # what earlier tests left in the allocator
    free, _ = torch.cuda.mem_get_info()
    if free < need + 2 * 2 ** 30:
        pytest.skip(f"needs ~{need / 2 ** 30:.0f} GB of free device memory")
    assert (b * p - tail) * c > 2 ** 31 - 1
    assert bl.gather_fwd_plan(b, 64, c, p, torch.bfloat16)["wide"] == wide
    x, ci, cw, ci_t, cw_t = _gather_tail_case(cuda, b, p, c, torch.bfloat16,
                                              tail, 21)
    out = bl.bilinear_gather(x, ci, cw)
    torch.cuda.synchronize()
    del ci, cw
    got = out[-1, -tail:].cpu().float()
    out[-1, -tail:] = 0
    assert not bool(out.any())
    ref = bl.bilinear_gather_plain(x[-1:].cpu().float(), ci_t[None],
                                   cw_t[None])[0]
    _report("K3f", b * p * c, got, ref)
    assert bool(((got - ref).abs() <= 1e-5 + 2 ** -8 * ref.abs()).all())
    assert ref.abs().max() > 0


@pytest.mark.cuda
def test_gather_bwd_dcw_past_2_31_corners(cuda):
    """K3dcw over 2**31 + 2**11 corners (64-bit warp indices; g holds 2**33
    bf16 values): the last 512 points' dots match the plain version, every
    skipped corner's is exactly 0."""
    b, p, c, tail = 1, 2 ** 29 + 2 ** 9, 8, 512
    torch.cuda.empty_cache()  # what earlier tests left in the allocator
    free, _ = torch.cuda.mem_get_info()
    if free < 40 * 2 ** 30:
        pytest.skip("needs ~34 GB of free device memory")
    assert bl.gather_dcw_plan(b, 64, c, p)["wide"]
    x, ci, cw, ci_t, _ = _gather_tail_case(cuda, b, p, c, torch.bfloat16,
                                           tail, 22)
    g = torch.zeros(b, p, c, dtype=torch.bfloat16, device=cuda)
    g_t = torch.from_numpy(np.random.RandomState(23).randn(tail, c).astype(
        np.float32))
    g[0, -tail:] = g_t.to(cuda, torch.bfloat16)
    dcw = bl.bilinear_gather_bwd_dcw(g, x, ci, cw)
    torch.cuda.synchronize()
    del g, ci, cw
    got = dcw[0, -tail:].cpu()
    dcw[0, -tail:] = 0
    assert not bool(dcw.any())
    ref = bl.bilinear_gather_bwd_dcw_plain(
        g_t.to(torch.bfloat16).float()[None], x.cpu().float(), ci_t[None])[0]
    _report("K3dcw", b * p * 4, got, ref)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert ref.abs().max() > 0


GATHER_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-5, 2 ** -8)}


def rcnn_rois(rs, b, r, res=512):
    """(b, r, 4) rois drawn like a 512 x 512 request's proposals: sizes
    log-uniform over 4-512 px, clipped to the image; every tenth roi a
    zero-padded slot, every tenth but one zero-area."""
    wh = np.exp(rs.uniform(np.log(4), np.log(res), (b, r, 2)))
    xy = rs.uniform(0, res, (b, r, 2)) - wh / 2
    rois = np.clip(np.concatenate([xy, xy + wh], -1), 0, res)
    rois[:, ::10] = 0.0
    rois[:, 1::10, 2:] = rois[:, 1::10, :2]
    return torch.from_numpy(rois.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rois, size", [(512, (7, 7)), (100, (14, 14))])
def test_gather_fwd_rcnn_shapes(cuda, dtype, rois, size):
    """K3f at each FPN level of a 512 x 512 request (C = 256; 128^2, 64^2,
    32^2 and 16^2 maps), batch 2, for the box head's 512 rois x 196
    samples and the mask head's 100 x 784, against the plain version on
    the same corners; and ``roi_align`` through it equals the gather of
    those corners."""
    rs = np.random.RandomState(24)
    boxes = rcnn_rois(rs, 2, rois).to(cuda)
    for stride in (4, 8, 16, 32):
        side = 512 // stride
        fmap = torch.from_numpy(rs.randn(2, side, side, 256).astype(
            np.float32)).to(cuda, dtype)
        got = ra.roi_align(fmap, boxes / stride, size)
        b, r = boxes.shape[:2]
        assert got.shape == (b, r) + size + (256,)
        # the same points through the gather alone, against the plain one
        ys, xs = ra.roi_sample_points(boxes / stride, size)
        ci, cw = bl.bilinear_corners(ys, xs, side, side)
        x = fmap.view(b, side * side, 256)
        out = bl.bilinear_gather(x, ci, cw)
        torch.cuda.synchronize()
        ref = bl.bilinear_gather_plain(x.cpu().float(), ci.cpu(), cw.cpu())
        atol, rtol = GATHER_TOL[dtype]
        err = (out.cpu().float() - ref).abs()
        assert bool((err <= atol + rtol * ref.abs()).all()), float(err.max())
        s = 2
        mean = out.view(b, r, size[0], s, size[1], s, 256).mean(dim=(3, 5))
        assert torch.equal(got, mean)



SEG_BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}


def _seg_stream(rs, b, n, bound, c):
    """A sorted stream: segments of 1 to ``bound`` rows, every seventh
    without a last kept row; x N(0, 1) with a third of it 0 (ties)."""
    first = np.zeros((b, n), bool)
    last = np.zeros((b, n), bool)
    for bi in range(b):
        i, k = 0, 0
        while i < n:
            ln = min(int(rs.randint(1, bound + 1)), n - i)
            first[bi, i] = True
            last[bi, i + ln - 1] = k % 7 != 6
            i, k = i + ln, k + 1
    x = rs.randn(b, n, c).astype(np.float32)
    x[rs.rand(b, n, c) < 0.3] = 0.0
    return torch.from_numpy(first), torch.from_numpy(last), torch.from_numpy(x)


def _check_seg(first, last, x, g, bound):
    """K5f exactly and K5b within SEG_BWD_TOL of their plain versions (on
    the CPU, in f32 for bf16 inputs, rounded once to x's type)."""
    m = sm.seg_full_max_bounded(first, last, x, bound)
    dx = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
    torch.cuda.synchronize()
    fc, lc, xc = first.cpu(), last.cpu(), x.cpu()
    ref_m = sm.seg_full_max_bounded_plain(fc, lc, xc, bound)
    assert torch.equal(m.cpu(), ref_m)
    ref = sm.seg_full_max_bounded_bwd_plain(fc, lc, xc, ref_m, g.cpu(),
                                            bound)
    atol, rtol = SEG_BWD_TOL[x.dtype]
    err = (dx.cpu().float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), float(
        err.max())
    return m, dx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 18, 20, 33])
def test_seg_max_kernels_take_any_width(cuda, dtype, c):
    """K5f and K5b at widths the kernels' 16-byte vectors do not divide:
    the wrappers pad x (and m and g) with zero channels and slice the
    result back to C, which leaves every channel's max and gradient as
    they are."""
    rs = np.random.RandomState(30 + c)
    first, last, x = _seg_stream(rs, 2, 1001, 20, c)
    g = torch.from_numpy(rs.randn(2, 1001, c).astype(np.float32))
    m, dx = _check_seg(first.to(cuda), last.to(cuda), x.to(cuda, dtype),
                       g.to(cuda, dtype), 20)
    assert m.shape == dx.shape == (2, 1001, c)
    assert m.is_contiguous() and dx.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_max_wide_entries_match_the_narrow_ones(cuda, dtype):
    """The 64-bit indices (``wide`` = 1: K5f's thread indices and K5b's row
    offsets, which the wrappers take from 2**31 vectors on) give the 32-bit
    ones' bits on a small stream: both C entries called directly."""
    rs = np.random.RandomState(40)
    first, last, x = _seg_stream(rs, 3, 777, 20, 16)
    f, l = first.to(cuda), last.to(cuda)
    xt = x.to(cuda, dtype)
    g = torch.from_numpy(rs.randn(3, 777, 16).astype(np.float32)).to(
        cuda, dtype)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    stream = kernels.cuda_stream(cuda)
    outs = []
    for wide in (0, 1):
        m = torch.empty_like(xt)
        dx = torch.empty_like(xt)
        kernels.SEG_FULL_MAX.check(kernels.SEG_FULL_MAX.fn()(
            xt.data_ptr(), f.data_ptr(), l.data_ptr(), m.data_ptr(), 3, 777,
            16, 20, code, wide, stream))
        plan = sm.seg_max_bwd_plan(3, 777, 16, dtype, 20)
        kernels.SEG_FULL_MAX_BWD.check(kernels.SEG_FULL_MAX_BWD.fn()(
            xt.data_ptr(), g.data_ptr(), f.data_ptr(), l.data_ptr(),
            dx.data_ptr(), 3, 777, 16, 16, 20, plan["tile_rows"],
            plan["chunk"], plan["smem"], code, wide, stream))
        outs.append((m, dx))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    _check_seg(f, l, xt, g, 20)


def _bwd_against_plain(first, last, x, g, bound):
    """K5b through the wrapper on the card against the plain version on
    the CPU (``SEG_BWD_TOL``; exact where a segment has at most two rows or
    a row is not covered); returns dx."""
    m = sm.seg_full_max_bounded(first, last, x, bound)
    dx = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
    torch.cuda.synchronize()
    fc, lc, xc, gc = first.cpu(), last.cpu(), x.cpu(), g.cpu()
    ref = sm.seg_full_max_bounded_bwd_plain(fc, lc, xc, m.cpu(), gc, bound)
    cov = sm.seg_covered(fc, lc, bound)
    seg = sm._seg_bcast_bounded(lc, sm._seg_sum_bounded(
        fc, cov.float(), bound), bound)  # covered rows per segment
    short = ~cov | (seg <= 2)
    got = dx.cpu()
    assert torch.equal(got[short], ref[short])
    atol, rtol = SEG_BWD_TOL[x.dtype]
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), float(
        err.max())
    return dx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_max_bwd_reads_a_strided_g_in_place(cuda, dtype):
    """g as the stream PFN's cat hands it, the second half of a (B, N, 2C)
    gradient: the kernel reads it in place (no copy is launched: K5b once,
    nothing else in between), and dx holds the bits of the same g made
    contiguous, within ``SEG_BWD_TOL`` of the plain version."""
    rs = np.random.RandomState(50)
    first, last, x = _seg_stream(rs, 3, 1001, 20, 32)
    full = torch.from_numpy(rs.randn(3, 1001, 64).astype(np.float32)).to(
        cuda, dtype)
    g = full[..., 32:]
    assert not g.is_contiguous() and g.stride(1) == 64
    f, l, xt = first.to(cuda), last.to(cuda), x.to(cuda, dtype)
    dx = _bwd_against_plain(f, l, xt, g, 20)
    m = sm.seg_full_max_bounded(f, l, xt, 20)
    assert torch.equal(dx, sm.seg_full_max_bounded_bwd(f, l, xt, m,
                                                       g.contiguous(), 20))
    kernels.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sm.seg_full_max_bounded_bwd(f, l, xt, m, g, 20)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels.SEG_FULL_MAX_BWD.launches == 1
    assert len(names) == 1 and "seg_full_max_bwd" in names[0], names


def _straddling_stream(n, tile, bound):
    """A segment of ``bound`` rows, kept whole, from ``bound`` // 2 rows
    before every tile edge to past it; the other rows in segments of 1 to
    3 rows, every fifth without a last kept row."""
    first = np.zeros((1, n), bool)
    last = np.zeros((1, n), bool)
    i, k = 0, 0
    while i < n:
        edge = (i // tile + 1) * tile
        across = edge - bound // 2 == i
        ln = bound if across else min(1 + k % 3, max(edge - bound // 2 - i,
                                                     1))
        ln = min(ln, n - i)
        first[0, i] = True
        last[0, i + ln - 1] = across or k % 5 != 4
        i, k = i + ln, k + 1
    return torch.from_numpy(first), torch.from_numpy(last)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_max_bwd_segments_straddle_tile_edges(cuda, dtype):
    """Segments whose head lies in one tile and whose last kept row lies in
    the next, at every tile edge, on a stream whose N is no multiple of
    the tile (the last tile short), with ties."""
    bound = 20
    tile = sm.seg_max_bwd_plan(1, 5 * 256 + 37, 16, dtype, bound)["tile_rows"]
    n = 5 * tile + 37
    assert sm.seg_max_bwd_plan(1, n, 16, dtype, bound)["tile_rows"] == tile
    first, last = _straddling_stream(n, tile, bound)
    for edge in range(tile, n - bound, tile):  # one segment across each
        head = edge - bound // 2
        assert first[0, head] and last[0, head + bound - 1]
        assert not first[0, head + 1:head + bound].any()
    rs = np.random.RandomState(51)
    x = torch.from_numpy(rs.randint(0, 3, (1, n, 16)).astype(np.float32))
    g = torch.from_numpy(rs.randn(1, n, 16).astype(np.float32))
    _bwd_against_plain(first.to(cuda), last.to(cuda), x.to(cuda, dtype),
                       g.to(cuda, dtype), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [1, 20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_max_bwd_bounds_and_clustered_ties(cuda, bound, dtype):
    """Bounds 1 (every covered row its own segment), 20 (the voxelizer's
    cap) and 64, on streams of segments up to the bound with x in {0, 1, 2}
    (ties in most segments) and N no multiple of the tile."""
    rs = np.random.RandomState(52 + bound)
    n = 3 * 256 + 101
    first, last, _ = _seg_stream(rs, 2, n, bound, 24)
    x = torch.from_numpy(rs.randint(0, 3, (2, n, 24)).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, n, 24).astype(np.float32))
    _bwd_against_plain(first.to(cuda), last.to(cuda), x.to(cuda, dtype),
                       g.to(cuda, dtype), bound)


@pytest.mark.cuda
def test_seg_max_bwd_refuses_a_bound_past_the_halo_budget(cuda):
    """A bound whose window passes a block's shared memory at one vector a
    row is refused before anything is launched; the largest bound that
    fits runs (one vector a row: its window is ~3300 rows)."""
    tile = sm.seg_max_bwd_plan(1, 4096, 8, torch.bfloat16, 20)["tile_rows"]
    window = (sm.SHARED_MEMORY_MAX - sm._seg_bwd_smem(tile, 1, 1)) // (
        2 * 16 + 2) + tile
    fits = (window - tile) // 2 + 1
    assert sm._seg_bwd_smem(tile, fits, 1) <= sm.SHARED_MEMORY_MAX \
        < sm._seg_bwd_smem(tile, fits + 1, 1)
    plan = sm.seg_max_bwd_plan(1, 4096, 8, torch.bfloat16, fits)
    assert plan["tile_rows"] == tile and plan["chunk"] == 1
    first = torch.zeros(1, 4096, dtype=torch.bool, device=cuda)
    last = torch.zeros(1, 4096, dtype=torch.bool, device=cuda)
    first[0, 0], last[0, 4095] = True, True
    x = torch.randn(1, 4096, 8, device=cuda).to(torch.bfloat16)
    g = torch.randn(1, 4096, 8, device=cuda).to(torch.bfloat16)
    m = sm.seg_full_max_bounded(first, last, x, fits)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        sm.seg_full_max_bounded_bwd(first, last, x, m, g, fits + 1)
    assert kernels.SEG_FULL_MAX_BWD.launches == 0
    _bwd_against_plain(first, last, x, g, fits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_max_bwd_stream_with_no_covered_row(cuda, dtype):
    """Heads and no last kept row anywhere (and a second stream with no flag
    at all): every dx is 0, whatever x and g hold."""
    rs = np.random.RandomState(53)
    n = 2 * 256 + 5
    x = torch.from_numpy(rs.randn(2, n, 8).astype(np.float32)).to(cuda,
                                                                   dtype)
    g = torch.from_numpy(rs.randn(2, n, 8).astype(np.float32)).to(cuda,
                                                                   dtype)
    last = torch.zeros(2, n, dtype=torch.bool, device=cuda)
    first = torch.zeros(2, n, dtype=torch.bool, device=cuda)
    first[0, ::7] = True
    dx = _bwd_against_plain(first, last, x, g, 20)
    assert not dx.any()


@pytest.mark.cuda
def test_seg_max_past_2_31_values(cuda):
    """K5f and K5b on a bf16 stream of more than 2**31 values (C = 8, one
    16-byte vector a row, one cloud): only the last 4,096 rows hold kept
    segments, and their rows lie past 2**31 values, so a 32-bit offset
    would read and write elsewhere. They match the plain versions on those
    rows; every other row is exactly 0. (Past 2**31 vectors the wrappers
    take the 64-bit thread indices, which
    ``test_seg_max_wide_entries_match_the_narrow_ones`` holds to the 32-bit
    ones.)"""
    c, tail, bound = 8, 4096, 20
    n = 2 ** 31 // c + tail
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    if free < 24 * 2 ** 30:
        pytest.skip("needs ~24 GB of free device memory")
    rs = np.random.RandomState(41)
    ft, lt, xt = _seg_stream(rs, 1, tail, bound, c)
    gt = torch.from_numpy(rs.randn(1, tail, c).astype(np.float32))
    first = torch.zeros(1, n, dtype=torch.bool, device=cuda)
    last = torch.zeros(1, n, dtype=torch.bool, device=cuda)
    first[:, -tail:], last[:, -tail:] = ft.to(cuda), lt.to(cuda)
    first[:, 0] = True  # the rows before the tail: one segment, not kept
    x = torch.zeros(1, n, c, dtype=torch.bfloat16, device=cuda)
    x[:, -tail:] = xt.to(cuda, torch.bfloat16)
    g = torch.ones(1, n, c, dtype=torch.bfloat16, device=cuda)
    g[:, -tail:] = gt.to(cuda, torch.bfloat16)
    assert (n - tail) * c > 2 ** 31 - 1  # the tail lies past int32
    assert not sm.seg_max_plan(1, n, c, torch.bfloat16)["wide"]
    m = sm.seg_full_max_bounded(first, last, x, bound)
    dx = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
    torch.cuda.synchronize()
    del g
    head_m, head_dx = bool(m[:, :-tail].any()), bool(dx[:, :-tail].any())
    got_m, got_dx = m[:, -tail:].cpu(), dx[:, -tail:].cpu()
    del m, dx, x
    assert not head_m and not head_dx
    xb, gb = xt.to(torch.bfloat16), gt.to(torch.bfloat16)
    ref_m = sm.seg_full_max_bounded_plain(ft, lt, xb, bound)
    assert torch.equal(got_m, ref_m)
    ref = sm.seg_full_max_bounded_bwd_plain(ft, lt, xb, ref_m, gb, bound)
    atol, rtol = SEG_BWD_TOL[torch.bfloat16]
    err = (got_dx.float() - ref.float()).abs()
    print(f"\n  K5f / K5b past 2**31 values ({n * c} values): K5f exact, "
          f"K5b max abs error on the tail {float(err.max()):.3e}")
    assert bool((err <= atol + rtol * ref.float().abs()).all())
    assert ref.float().abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 6])
def test_warp_images_launches_the_row_gather(cuda, c):
    """``data/transforms.py:warp_images`` on a CUDA tensor: with no
    gradient asked, one launch of the warp kernel per warp and none of the
    row gather (K3f); the result within ``GATHER_TOL`` of the same warp on
    the CPU (the plain gather), points off the image included. With a
    gradient asked of the images, one K3f launch and none of the warp
    kernel, and the backward runs."""
    from minddet_tpu_torch.data.transforms import warp_images

    rs = np.random.RandomState(c)
    images = torch.from_numpy(rs.rand(2, 37, 45, c).astype(np.float32))
    aff = torch.tensor([[[1.3, 0.2, -4.0], [-0.1, 1.1, 3.5]],
                        [[-0.8, 0.0, 40.0], [0.0, 0.9, -2.0]]])
    want = warp_images(images, aff, (29, 33))
    kernels.reset_launches()
    got = warp_images(images.to(cuda), aff.to(cuda), (29, 33))
    torch.cuda.synchronize()
    assert kernels.BILINEAR_WARP_AFFINE_FWD.launches == 1
    assert kernels.BILINEAR_GATHER_FWD.launches == 0
    assert got.shape == want.shape and got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= 1e-5 + 1e-6
    assert (want == 0).any() and (want > 0).any()
    graded = images.to(cuda).requires_grad_()
    again = warp_images(graded, aff.to(cuda), (29, 33))
    again.sum().backward()
    torch.cuda.synchronize()
    assert kernels.BILINEAR_WARP_AFFINE_FWD.launches == 1
    assert kernels.BILINEAR_GATHER_FWD.launches == 1
    assert kernels.BILINEAR_GATHER_BWD_DX.launches == 1
    assert _same_bits(again.detach(), got)
    assert graded.grad.shape == graded.shape


def _k3f_warp(x, aff, out_hw):
    """The warp by the route it replaced: ``affine_points`` ->
    ``bilinear_corners`` -> the row gather (K3f)."""
    b, h, w, c = x.shape
    ys, xs = bl.affine_points(aff, out_hw)
    ci, cw = bl.bilinear_corners(ys, xs, h, w)
    return bl.bilinear_gather(x.view(b, h * w, c), ci, cw).view(
        b, *out_hw, c)


def _check_warp(x, aff, out_hw, plain=True):
    """The warp kernel against the K3f route bit for bit and (``plain``)
    against its plain version in f32 on the same values (``GATHER_TOL``:
    bf16 is that f32 sum rounded once; NaN where it is NaN); one launch.
    Returns the kernel's result."""
    before = kernels.BILINEAR_WARP_AFFINE_FWD.launches
    got = bl.bilinear_warp_affine(x, aff, out_hw)
    route = _k3f_warp(x, aff, out_hw)
    torch.cuda.synchronize()
    assert kernels.BILINEAR_WARP_AFFINE_FWD.launches == before + 1
    assert got.dtype == x.dtype and got.shape == route.shape
    assert _same_bits(got, route)
    if not plain:
        return got
    ref = bl.bilinear_warp_affine_plain(x.float(), aff, out_hw)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got.float()), nan)
    atol, rtol = GATHER_TOL[x.dtype]
    err = (got.float() - ref).abs()[~nan]
    assert bool((err <= atol + rtol * ref.abs()[~nan]).all()), float(
        err.max())
    return got


# the warp cases' affines: a scale with a shift, a horizontal flip, a
# rotation
WARP_AFFINES = [[[1.3, 0.0, -4.0], [0.0, 1.3, 3.5]],
                [[-0.8, 0.0, 40.0], [0.0, 0.8, -2.0]],
                [[1.1, 0.25, -6.0], [-0.2, 0.95, 5.0]]]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [48, 45])
@pytest.mark.parametrize("c", [1, 3, 4, 5, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_affine_widths(cuda, dtype, c, w):
    """Every width of both routes (the pixel route up to one 16-byte vector
    a pixel, the vector route past it, aligned or not), on map rows that
    are whole 16-byte chunks (W = 48) and rows that may not be (W = 45),
    under a scale, a flip and a rotation, to an output of partial tiles."""
    rs = np.random.RandomState(c + w)
    x = torch.from_numpy(rs.rand(3, 37, w, c).astype(np.float32)).to(
        cuda, dtype)
    aff = torch.tensor(WARP_AFFINES, device=cuda)
    got = _check_warp(x, aff, (29, 70))
    assert (got == 0).any() and (got > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_affine_strong_downscale_with_rotation(cuda, dtype):
    """A 6x downscale with a rotation (each warp's loads spread over many
    map rows) beside a mild scale in the same launch."""
    h, w, c = 300, 400, 3
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.rand(2, h, w, c).astype(np.float32)).to(
        cuda, dtype)
    ang, s = 0.5, 6.0
    aff = [[[s * np.cos(ang), -s * np.sin(ang), 150.0],
            [s * np.sin(ang), s * np.cos(ang), 0.0]],
           [[1.2, 0.0, 3.0], [0.0, 1.2, 1.0]]]
    got = _check_warp(x, torch.tensor(aff, device=cuda, dtype=torch.float32),
                      (40, 64))
    assert (got[0] > 0).any() and (got[0] == 0).any()
    assert (got[1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 4, 128])
def test_warp_affine_every_point_off_the_map(cuda, c):
    """Far translations, a NaN affine and an infinite one: every corner off
    the map (NaN coordinates fail the in-map tests), so exact zeros, as
    K3f gives them (it skips an off-map corner whatever its weight). The
    plain version is held on the finite ones only: it multiplies an
    off-map corner's weight by 0, which leaves a NaN weight NaN, as the
    reference's XLA gather does."""
    rs = np.random.RandomState(c)
    x = torch.from_numpy(rs.rand(2, 16, 32, c).astype(np.float32)).to(cuda)
    far = torch.tensor([[[1.0, 0.0, 1e4], [0.0, 1.0, 0.0]],
                        [[1.0, 0.0, 0.0], [0.0, 1.0, -1e30]]], device=cuda)
    odd = torch.tensor([[[float("nan"), 0.0, 0.0], [0.0, 1.0, 0.0]],
                        [[1.0, 0.0, 0.0], [0.0, float("inf"), 0.0]]],
                       device=cuda)
    assert not _check_warp(x, far, (20, 40)).any()
    assert not _check_warp(x, odd, (20, 40), plain=False).any()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 4])
def test_warp_affine_one_pixel_map(cuda, c):
    """A 1 x 1 map: only the corners at (0, 0) read; past x = 11 none."""
    x = torch.tensor([[[[0.5, 0.25, 2.0, -1.0][:c]]]], device=cuda)
    aff = torch.tensor([[[0.1, 0.0, -0.2], [0.0, 0.1, -0.35]]], device=cuda)
    got = _check_warp(x, aff, (9, 30))
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_affine_nan_through_a_zero_weight_corner(cuda, dtype):
    """A whole-pixel translation gives the three corners past the first a
    weight of 0; a NaN pixel still reaches the outputs that read it as such
    a corner, as in K3f."""
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 20, 32, 3).astype(
        np.float32)).to(cuda, dtype)
    x[0, 5, 10, 1] = float("nan")
    aff = torch.tensor([[[1.0, 0.0, 2.0], [0.0, 1.0, 1.0]]], device=cuda)
    got = _check_warp(x, aff, (16, 24))
    nan = torch.isnan(got[0, :, :, 1])
    # outputs (y, x) read pixels (y + 1 .. y + 2, x + 2 .. x + 3)
    assert sorted(map(tuple, nan.nonzero().tolist())) == [
        (3, 7), (3, 8), (4, 7), (4, 8)]
    assert not torch.isnan(got[..., 0]).any()


@pytest.mark.cuda
def test_soft_nms_on_the_card_matches_the_cpu(cuda):
    """``ops/nms.py:soft_nms`` over (80, 128) sets on the card: the same
    order as on the CPU and the rescored scores within 1e-6 (the decays'
    exp and products in f32); no kernel of the port launches."""
    from minddet_tpu_torch.ops.nms import soft_nms

    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 200, (80, 128, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(5, 60, (80, 128, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(np.stack([  # apart by 8e-3 at the start
        rs.permutation(np.linspace(1e-3, 1, 128)) for _ in range(80)]
    ).astype(np.float32))
    scores[:, 100:] = 0.0
    want, want_order = soft_nms(boxes, scores, sigma=0.5,
                                score_threshold=1e-3)
    kernels.reset_launches()
    got, order = soft_nms(boxes.to(cuda), scores.to(cuda), sigma=0.5,
                          score_threshold=1e-3)
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in kernels.KERNELS)
    assert torch.equal(order.cpu(), want_order)
    assert float((got.cpu() - want).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["bev", "3d"])
def test_iou_kitti_eval_chunk(cuda, metric):
    """K4 at the KITTI evaluator's chunk, (64, 24, 5) x (64, 100, 5) boxes
    in the camera frame's BEV, DontCare rows (1000 m off, negative extents)
    and zero-padded rows on both sides: the intersections and the IoUs
    (``rotated_iou_bev``, or ``rotated_iou_3d`` through the BEV slice)
    against the plain version at ``IOU_TOL``, one launch per call."""
    from chip_smoke import kitti_eval_chunk

    gt, dt = (t.numpy() for t in kitti_eval_chunk(64, (24, 100), seed=12,
                                                  metric=metric))
    bev = [0, 1, 3, 4, 6] if metric == "3d" else slice(None)
    got, ref, sep = _check_iou(np.ascontiguousarray(gt[..., bev]),
                               np.ascontiguousarray(dt[..., bev]), cuda)
    assert float((ref > 0).float().mean()) > 0.005
    fn = ri.rotated_iou_3d if metric == "3d" else ri.rotated_iou_bev
    kernels.reset_launches()
    t_gt, t_dt = torch.from_numpy(gt), torch.from_numpy(dt)
    iou = fn(t_gt.to(cuda), t_dt.to(cuda))
    torch.cuda.synchronize()
    assert kernels.ROTATED_IOU.launches == 1
    want = fn(t_gt, t_dt)
    real_g = t_gt[..., 3].abs() > 0  # padded rows have zero extents
    real_d = t_dt[..., 3].abs() > 0
    pair = real_g[:, :, None] & real_d[:, None, :]
    torch.testing.assert_close(iou.cpu()[pair], want[pair], **IOU_TOL)
    dontcare = (t_gt[..., 0] == -1000)[:, :, None] & real_d[:, None, :]
    assert bool(dontcare.any())
    assert bool((iou.cpu()[dontcare] == 0).all())


@pytest.mark.cuda
def test_host_ops_library_builds_and_loads(cuda):
    """The port's host-ops C++ builds with the host compiler and answers:
    a 2 x 2 box inside a 10 x 10 one covers 4 % of it."""
    from minddet_tpu_torch.ops import host_ops

    assert host_ops.build().exists() and host_ops.available()
    big = np.array([[0, 0, 10, 10, 0.3]], np.float32)
    small = np.array([[0, 0, 2, 2, 0.9]], np.float32)
    np.testing.assert_allclose(
        host_ops.rotated_iou_matrix(big, small, criterion=0), [[0.04]],
        atol=1e-5)
    np.testing.assert_allclose(
        host_ops.rotated_iou_matrix(big, small, criterion=1), [[1.0]],
        atol=1e-5)
