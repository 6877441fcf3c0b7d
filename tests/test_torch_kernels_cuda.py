"""The hand-written kernels redesigned for Hopper against their plain
versions on the card, at small shapes: the row gather's map backward
(K3dx), the DCN samplers' backward (K1b, and K2b, its flat entry), the
rotated-box intersection (K4), and the row gather's three kernels at
widths that are not a whole number of 16-byte vectors.

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
  them, at the tolerances of the C % 8 == 0 cases.
"""

import numpy as np
import pytest
import torch

from minddet_tpu_torch.ops import bilinear as bl
from minddet_tpu_torch.ops import hat_sample as hs
from minddet_tpu_torch.ops import rotated_iou as ri

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
