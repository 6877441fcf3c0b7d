"""The port's bounded segment max vs the JAX package's, on the CPU.

``seg_full_max_bounded`` of the port runs its plain version here (the
shift-level form, zeroed outside ``seg_covered``); the JAX function runs its
Pallas body in interpret mode and its XLA form. The two are compared at the
rows between a segment's head and its last kept row (``seg_covered``; for a
voxelizer stream its kept rows): the reference leaves the other rows to
whatever its shift levels produce, the port puts 0 there. f32 within 1e-6,
bf16 exactly (max and select only).

The backward (``seg_full_max_bounded_bwd_plain``, which the autograd function
runs on the CPU) is compared with the reference's Pallas backward in
interpret mode on streams with ties (even split on both sides; f32 sums in
another order, atol 1e-5), with autodiff of its XLA form on tie-free inputs,
and checked to conserve each segment's summed gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_seg_pallas import _random_stream

from minddet_tpu.ops.seg_pallas import _run_bwd as j_run_bwd
from minddet_tpu.ops.seg_pallas import _run_fwd as j_run_fwd
from minddet_tpu.ops.seg_pallas import seg_full_max_bounded as j_seg_full_max
from minddet_tpu_torch.models.readers.pillar_encoder import PillarFeatureNet
from minddet_tpu_torch.ops.seg_max import (seg_covered, seg_full_max_bounded,
                                           seg_full_max_bounded_bwd,
                                           seg_full_max_bounded_bwd_plain,
                                           seg_full_max_bounded_plain)
from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch


def _brute(first, last, x, bound):
    """Per row: the max over [head, last] of its segment, 0 elsewhere."""
    out = np.zeros_like(x)
    covered = np.zeros(first.shape, bool)
    b, n = first.shape
    for bi in range(b):
        head = None
        for i in range(n):
            if first[bi, i]:
                head = i
            if last[bi, i] and head is not None and i - head < bound:
                out[bi, head:i + 1] = x[bi, head:i + 1].max(0)
                covered[bi, head:i + 1] = True
                head = None  # rows past the last kept row are not covered
    return out, covered


@pytest.mark.parametrize("n,tn,bound,c", [(512, 128, 6, 8), (1000, 256, 6, 8),
                                          (900, 256, 20, 32)])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_matches_jax_f32(n, tn, bound, c, impl):
    """N = 1000 and 900 are no multiple of the Pallas tile."""
    first, last, x = _random_stream(np.random.RandomState(0), 2, n, bound,
                                    c=c)
    kw = dict(block_rows=tn, interpret=True) if impl == "pallas_interpret" \
        else dict(implementation="xla")
    ref = np.asarray(j_seg_full_max(jnp.asarray(first), jnp.asarray(last),
                                    jnp.asarray(x), bound, **kw))
    got = seg_full_max_bounded(torch.from_numpy(first),
                               torch.from_numpy(last), torch.from_numpy(x),
                               bound).numpy()
    covered = seg_covered(torch.from_numpy(first), torch.from_numpy(last),
                          bound).numpy()
    assert covered.all()  # these streams have no row outside a segment
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, _brute(first, last, x, bound)[0])


def test_matches_jax_bf16_exactly():
    bound = 20
    first, last, x = _random_stream(np.random.RandomState(1), 2, 900, bound,
                                    c=64)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(j_seg_full_max(jnp.asarray(first), jnp.asarray(last),
                                    xb, bound, block_rows=256,
                                    interpret=True).astype(jnp.float32))
    got = seg_full_max_bounded(torch.from_numpy(first),
                               torch.from_numpy(last),
                               torch.from_numpy(x).to(torch.bfloat16), bound)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_voxelizer_stream_with_overflow_matches_jax_at_kept_rows():
    """A stream from the port's voxelizer: pillars with more points than the
    cap (rows past ``last``), more pillars than ``max_voxels`` (segments with
    no ``last``) and an invalid tail. Compared with JAX at the kept rows;
    everywhere else the port holds 0."""
    rs = np.random.RandomState(2)
    pts = rs.uniform([0, 0, -1, 0], [3.2, 3.2, 1, 1], (2, 700, 4)).astype(
        np.float32)
    mask = rs.uniform(size=(2, 700)) < 0.9
    bound = 4
    sv = voxelize_stream_batch(torch.from_numpy(pts), torch.from_numpy(mask),
                               (0.4, 0.4, 2.0), (0, 0, -1, 3.2, 3.2, 1),
                               max_voxels=40, max_points=bound,
                               drop_order="sorted")
    keep = sv.keep.numpy()
    covered = seg_covered(sv.first, sv.last, bound).numpy()
    np.testing.assert_array_equal(covered, keep)
    assert 0.2 < keep.mean() < 0.8
    x = rs.randn(2, 700, 8).astype(np.float32)
    got = seg_full_max_bounded(sv.first, sv.last, torch.from_numpy(x),
                               bound).numpy()
    ref = np.asarray(j_seg_full_max(jnp.asarray(sv.first.numpy()),
                                    jnp.asarray(sv.last.numpy()),
                                    jnp.asarray(x), bound, block_rows=128,
                                    interpret=True))
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6, atol=1e-6)
    assert (got[~keep] == 0).all()
    want, want_cov = _brute(sv.first.numpy(), sv.last.numpy(), x, bound)
    np.testing.assert_array_equal(want_cov, keep)
    np.testing.assert_array_equal(got, want)


def test_two_layer_pfn_ignores_rows_that_are_not_kept():
    """The two-layer stream PFN's output at each pillar's last kept row does
    not depend on what the rows that are not kept hold."""
    rs = np.random.RandomState(3)
    pts = rs.uniform([0, 0, -1, 0], [3.2, 3.2, 1, 1], (1, 500, 4)).astype(
        np.float32)
    sv = voxelize_stream_batch(torch.from_numpy(pts),
                               torch.ones(1, 500, dtype=torch.bool),
                               (0.4, 0.4, 2.0), (0, 0, -1, 3.2, 3.2, 1),
                               max_voxels=40, max_points=4,
                               drop_order="sorted")
    torch.manual_seed(0)
    pfn = PillarFeatureNet(9, (16, 16)).eval()
    noisy = torch.where(sv.keep[..., None], sv.feats,
                        torch.from_numpy(rs.randn(1, 500, 9).astype(
                            np.float32)) * 50)
    assert not sv.keep.all()
    with torch.no_grad():
        a = pfn.stream(sv.feats, sv.keep, sv.first, sv.last, bound=4)
        b = pfn.stream(noisy, sv.keep, sv.first, sv.last, bound=4)
    assert sv.last.sum() == 40
    np.testing.assert_array_equal(a[sv.last].numpy(), b[sv.last].numpy())
    assert a[sv.last].abs().sum() > 0


def _torch_grad(first, last, x, g, bound, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = seg_full_max_bounded(torch.from_numpy(first),
                               torch.from_numpy(last), xt, bound)
    out.backward(torch.from_numpy(g).to(dtype))
    return xt.grad


@pytest.mark.parametrize("n,tn,bound,c", [(512, 128, 6, 8), (900, 256, 20, 32)])
def test_backward_matches_pallas_interpret_with_ties(n, tn, bound, c):
    """The streams hold zeros in 30 % of the values, so most segments tie
    somewhere; both sides split a tie evenly."""
    rs = np.random.RandomState(6)
    first, last, x = _random_stream(rs, 2, n, bound, c=c)
    g = rs.randn(*x.shape).astype(np.float32)
    jf, jl, jx = jnp.asarray(first), jnp.asarray(last), jnp.asarray(x)
    m = j_run_fwd(jf, jl, jx, bound, tn, True)
    ref = np.asarray(j_run_bwd(jf, jl, jx, m, jnp.asarray(g), bound, tn,
                               True))
    got = _torch_grad(first, last, x, g, bound).numpy()
    ties = (x == np.asarray(m)).sum() - last.sum() * c
    assert ties > 100
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_backward_matches_xla_autodiff_without_ties():
    rs = np.random.RandomState(7)
    bound = 20
    first, last, _ = _random_stream(rs, 2, 700, bound, c=16)
    x = rs.permutation(2 * 700 * 16).reshape(2, 700, 16).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    jf, jl = jnp.asarray(first), jnp.asarray(last)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(j_seg_full_max(
        jf, jl, v, bound, implementation="xla") * jnp.asarray(g)))(
            jnp.asarray(x)))
    got = _torch_grad(first, last, x, g, bound).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_xla_autodiff_splits_a_three_way_tie_unevenly():
    """The reference's two backwards disagree on ties: the Pallas kernel
    (and the port) give three tied rows a third each, autodiff of the XLA
    shift levels gives them 1/2, 1/4, 1/4."""
    first = np.array([[True, False, False]])
    last = np.array([[False, False, True]])
    x = np.ones((1, 3, 8), np.float32)
    g = np.zeros((1, 3, 8), np.float32)
    g[0, 2] = 1.0
    ref = np.asarray(jax.grad(lambda v: jnp.sum(j_seg_full_max(
        jnp.asarray(first), jnp.asarray(last), v, 4, implementation="xla")
        * jnp.asarray(g)))(jnp.asarray(x)))
    got = _torch_grad(first, last, x, g, 4).numpy()
    np.testing.assert_allclose(got[0, :, 0], [1 / 3] * 3, rtol=1e-6)
    assert sorted(ref[0, :, 0].tolist()) == [0.25, 0.25, 0.5]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_conserves_each_segments_gradient(dtype):
    """On a voxelizer stream with both overflows: the sum of dx over a
    segment is the sum of g over its kept rows, and rows that are not kept
    get none (f32 1e-4; bf16 sums of up to 4 values rounded once each, 5e-2)."""
    rs = np.random.RandomState(8)
    pts = rs.uniform([0, 0, -1, 0], [3.2, 3.2, 1, 1], (2, 700, 4)).astype(
        np.float32)
    bound = 4
    sv = voxelize_stream_batch(torch.from_numpy(pts),
                               torch.ones(2, 700, dtype=torch.bool),
                               (0.4, 0.4, 2.0), (0, 0, -1, 3.2, 3.2, 1),
                               max_voxels=40, max_points=bound,
                               drop_order="sorted")
    x = torch.from_numpy(rs.randint(0, 3, (2, 700, 8)).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 700, 8).astype(np.float32)).to(dtype)
    xt = x.to(dtype).requires_grad_()
    seg_full_max_bounded(sv.first, sv.last, xt, bound).backward(g)
    dx = xt.grad
    assert dx.dtype == dtype and not sv.keep.all()
    assert (dx[~sv.keep] == 0).all()
    seg = torch.cumsum(sv.first.long(), 1) - 1  # segment id per row
    kept = sv.keep[..., None].float()
    sums = torch.zeros(2, 700, 8).scatter_add_(
        1, seg[..., None].expand(-1, -1, 8), dx.float() * kept)
    want = torch.zeros(2, 700, 8).scatter_add_(
        1, seg[..., None].expand(-1, -1, 8), g.float() * kept)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(sums, want, rtol=0, atol=tol)


def test_backward_gradcheck_f64():
    """The autograd function against finite differences, tie-free."""
    rs = np.random.RandomState(9)
    first, last, _ = _random_stream(rs, 1, 40, 5, c=3)
    x = torch.from_numpy(rs.permutation(120).reshape(1, 40, 3).astype(
        np.float64)).requires_grad_()
    f, l = torch.from_numpy(first), torch.from_numpy(last)
    assert torch.autograd.gradcheck(
        lambda v: seg_full_max_bounded(f, l, v, 5), (x,), eps=1e-3)


def test_requires_grad_raises_until_the_backward_is_ported():
    """The backward is ported: a tensor that requires grad differentiates,
    through the hand-written backward, with or without grad mode. (The test
    keeps the name it had while this call raised, so that its record stays
    one test's; it now checks the routing through the autograd function.)"""
    first, last, x = _random_stream(np.random.RandomState(4), 1, 64, 4)
    f, l = torch.from_numpy(first), torch.from_numpy(last)
    xt = torch.from_numpy(x).requires_grad_()
    out = seg_full_max_bounded(f, l, xt, 4)
    assert out.grad_fn is not None and "SegFullMax" in type(out.grad_fn).__name__
    g = torch.ones_like(out)
    out.backward(g)
    torch.testing.assert_close(
        xt.grad, seg_full_max_bounded_bwd_plain(f, l, xt.detach(),
                                                out.detach(), g, 4))
    with torch.no_grad():  # the eval path of a model with parameters
        assert seg_full_max_bounded(f, l, xt, 4).grad_fn is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype):
    first, last, x = _random_stream(np.random.RandomState(5), 2, 3001, 20,
                                    c=32)
    last[:, ::7] = False  # segments with no last row, rows past it
    f, l = torch.from_numpy(first).to(cuda), torch.from_numpy(last).to(cuda)
    xt = torch.from_numpy(x).to(cuda, dtype)
    got = seg_full_max_bounded(f, l, xt, 20)
    torch.cuda.synchronize()
    assert torch.equal(got, seg_full_max_bounded_plain(f, l, xt, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_backward_kernel_matches_plain(cuda, dtype, tol):
    rs = np.random.RandomState(10)
    first, last, x = _random_stream(rs, 2, 3001, 20, c=32)
    last[:, ::7] = False
    f, l = torch.from_numpy(first).to(cuda), torch.from_numpy(last).to(cuda)
    xt = torch.from_numpy(x).to(cuda, dtype)
    g = torch.from_numpy(rs.randn(*x.shape).astype(np.float32)).to(cuda,
                                                                   dtype)
    m = seg_full_max_bounded(f, l, xt, 20)
    got = seg_full_max_bounded_bwd(f, l, xt, m, g, 20)
    torch.cuda.synchronize()
    ref = seg_full_max_bounded_bwd_plain(f, l, xt, m, g, 20)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype, c, padded", [
    (torch.float32, 1, 4), (torch.float32, 18, 20), (torch.float32, 32, 32),
    (torch.bfloat16, 3, 8), (torch.bfloat16, 18, 24),
    (torch.bfloat16, 33, 40)])
def test_seg_max_wrappers_pad_any_width(dtype, c, padded):
    """The kernels take whole 16-byte vectors: a stream of any C is padded
    with zero channels to the next multiple of 4 (f32) or 8 (bf16), which
    the launch checks accept, and K5f's plan covers every padded vector of
    every row with its tiles and chunks (meta tensors: nothing is allocated
    or launched)."""
    from minddet_tpu_torch.ops import seg_max as sm

    x = torch.empty(8, 120000, c, dtype=dtype, device="meta")
    flags = torch.empty(8, 120000, dtype=torch.bool, device="meta")
    xp = sm.pad_channels(x)
    assert xp.shape == (8, 120000, padded)
    sm._check(flags, flags, xp, 20)
    vec = 4 if dtype == torch.float32 else 8
    plan = sm.seg_max_plan(8, 120000, padded, dtype, 20)
    nv = padded // vec
    assert plan["chunk"] == min(nv, sm.SEG_FWD_CHUNK)
    assert plan["blocks"] == 8 * -(-120000 // plan["tile_rows"]) * -(
        -nv // plan["chunk"])
    assert plan["halo"] == 19 and not plan["wide"]
    if c % vec:
        with pytest.raises(ValueError, match="not padded"):
            sm._check(flags, flags, x, 20)


def test_seg_max_plans_take_past_2_31_values_and_refuse_the_grid():
    """Past 2**31 values the plan keeps 32-bit row offsets (offsets are
    64-bit only from 2**31 vectors on), past 2**31 vectors it takes 64-bit
    ones; it refuses a size past the kernels' int arguments and a launch
    past the grid's blocks."""
    from minddet_tpu_torch.ops import seg_max as sm

    n = 2 ** 28 + 4096  # 8 bf16 channels: past 2**31 values
    x = torch.empty(1, n, 8, dtype=torch.bfloat16, device="meta")
    flags = torch.empty(1, n, dtype=torch.bool, device="meta")
    sm._check(flags, flags, x, 20)
    assert not sm.seg_max_plan(1, n, 8, torch.bfloat16, 20)["wide"]
    assert sm.seg_max_plan(9, n, 8, torch.bfloat16, 20)["wide"]
    assert sm.seg_max_plan(8, 2 ** 28, 8, torch.bfloat16, 20)["wide"]
    assert not sm.seg_max_plan(8, 2 ** 28 - 1, 8, torch.bfloat16,
                               20)["wide"]
    with pytest.raises(ValueError, match="32-bit"):
        sm.seg_max_plan(1, 2 ** 31, 8, torch.bfloat16, 20)
    with pytest.raises(ValueError, match="grid"):
        sm.seg_max_plan(2 ** 20, 2 ** 20, 2 ** 10, torch.float32, 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 18, 32, 64, 384])
def test_seg_max_plan_tiles_with_a_halo_in_shared_memory(dtype, c):
    """K5f's plan: chunks of up to ``SEG_FWD_CHUNK`` 16-byte vectors of a
    row, tiles of at most ``SEG_FWD_TILE`` rows and ``SEG_FWD_WORK`` rows
    times vectors (64 rows at least), not halved where the grid would not
    fill the card; a halo of bound - 1 rows on each side; its shared memory
    (per tile row three ints and a chunk of maxima, per window row x's
    chunk and two flag bits) within a block's 227 KB at every width the
    wrapper pads to; 32-bit offsets at the main paths' sizes."""
    from minddet_tpu_torch.ops import seg_max as sm

    padded = sm.pad_channels(torch.empty(1, 1, c, dtype=dtype,
                                         device="meta")).shape[-1]
    nv = padded // (4 if dtype == torch.float32 else 8)
    for b, n, bound in ((8, 120000, 20), (4, 160000, 20), (1, 120000, 20),
                        (1, 1281, 1), (2, 255, 64)):
        plan = sm.seg_max_plan(b, n, padded, dtype, bound)
        tile, chunk = plan["tile_rows"], plan["chunk"]
        assert chunk == min(nv, sm.SEG_FWD_CHUNK) and plan["halo"] == bound - 1
        assert 64 <= tile <= sm.SEG_FWD_TILE
        assert tile * chunk <= sm.SEG_FWD_WORK or tile == 64
        assert plan["blocks"] == b * -(-n // tile) * -(-nv // chunk)
        window = tile + 2 * (bound - 1)
        assert plan["smem"] >= 12 * tile + (window + tile) * 16 * chunk \
            + window / 4
        assert plan["smem"] == sm._seg_fwd_smem(tile, bound, chunk)
        assert plan["smem"] <= 227 * 1024
        assert not plan["wide"]
    # the main paths' shapes: a whole row of C = 32 a block, 512 row
    # vectors, at batch 1 too
    bf = sm.seg_max_plan(8, 120000, 32, torch.bfloat16, 20)
    f32 = sm.seg_max_plan(4, 120000, 32, torch.float32, 20)
    wm = sm.seg_max_plan(4, 160000, 32, torch.float32, 20)
    one = sm.seg_max_plan(1, 120000, 32, torch.bfloat16, 20)
    assert (bf["tile_rows"], bf["chunk"], bf["blocks"]) == (128, 4, 7504)
    assert (f32["tile_rows"], f32["chunk"], f32["blocks"]) == (64, 8, 7500)
    assert (wm["tile_rows"], wm["chunk"], wm["blocks"]) == (64, 8, 10000)
    assert (one["tile_rows"], one["blocks"]) == (128, 938)


def test_seg_max_plan_shrinks_the_chunk_and_refuses_a_window_too_large():
    """A long bound's window shrinks the chunk until it fits a block's
    232,448 bytes of shared memory; past that at one vector a row the plan
    refuses; the bound at which the window no longer fits is the one the
    byte count gives. A bound below 1 is refused."""
    from minddet_tpu_torch.ops import seg_max as sm

    bf = torch.bfloat16
    assert sm.seg_max_plan(1, 100, 32, bf, 20)["chunk"] == 4
    assert sm.seg_max_plan(1, 100, 32, bf, 2000)["chunk"] == 2
    assert sm.seg_max_plan(1, 100, 32, bf, 5000)["chunk"] == 1
    tile = sm.seg_max_plan(1, 100, 8, bf, 20)["tile_rows"]
    fits = max(bound for bound in range(1, 8000)
               if sm._seg_fwd_smem(tile, bound, 1) <= sm.SHARED_MEMORY_MAX)
    assert sm._seg_fwd_smem(tile, fits + 1, 1) > 232448
    assert sm.seg_max_plan(1, 100, 8, bf, fits)["smem"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        sm.seg_max_plan(1, 100, 8, bf, fits + 1)
    with pytest.raises(ValueError, match="bound"):
        sm.seg_max_plan(1, 100, 8, bf, 0)


def _overflowing_stream(rs, b, n, bound):
    """``_random_stream`` with segments of up to 2 * bound rows, their last
    kept row at most ``bound`` - 1 rows after the head (rows past it, as a
    pillar over the point cap gives), every fifth with none (a dropped
    pillar), and a tail of rows that belong to no kept segment."""
    first = np.zeros((b, n), bool)
    last = np.zeros((b, n), bool)
    for bi in range(b):
        i, k = 0, 0
        tail = n - int(rs.randint(0, n // 4 + 1))
        while i < n:
            ln = min(int(rs.randint(1, 2 * bound + 1)), n - i)
            first[bi, i] = True
            if k % 5 != 4 and i < tail:
                last[bi, i + min(ln, int(rs.randint(1, bound + 1))) - 1] = True
            i, k = i + ln, k + 1
    x = rs.randn(b, n, 3).astype(np.float32)
    return first, last, x


@pytest.mark.parametrize("bound,tile", [(1, 64), (2, 64), (20, 64),
                                        (20, 128), (20, 8), (40, 16),
                                        (20, None)])
def test_seg_max_tiles_see_every_segment_through_their_halo(bound, tile):
    """The kernels' tiling: the plain version run window by window (each
    tile's rows with ``halo`` rows before and after, cut at the sample's
    ends) gives, at the tile's rows, the plain version's result on the whole
    stream. Random streams of B = 2 with segments across the tile seams,
    rows past a segment's last kept row and segments with none; N no
    multiple of the tile; tiles shorter than the bound; ``None``: the tile
    and halo of K5f's plan."""
    from minddet_tpu_torch.ops import seg_max as sm

    rs = np.random.RandomState(12 + bound)
    n = 1000 + 37
    first, last, x = _overflowing_stream(rs, 2, n, bound)
    halo = bound - 1
    if tile is None:
        plan = sm.seg_max_plan(2, n, 4, torch.float32, bound)
        tile, halo = plan["tile_rows"], plan["halo"]
    assert n % tile
    # a whole kept segment of ``bound`` rows whose max lies at its head,
    # halo rows before a tile edge, and whose last kept row is the edge
    e = tile * max(1, -(-halo // tile))
    first[:, e - halo:e + 2] = [True] + [False] * halo + [True]
    last[:, e - halo:e + 1] = [False] * halo + [True]
    x[:, e - halo] = 100.0
    f, l, xt = (torch.from_numpy(a) for a in (first, last, x))
    whole = seg_full_max_bounded_plain(f, l, xt, bound)
    cov = seg_covered(f, l, bound)
    assert 0.2 < cov.float().mean() < 0.9
    tiled = torch.full_like(whole, float("nan"))
    for t0 in range(0, n, tile):
        w0, w1 = max(t0 - halo, 0), min(t0 + tile + halo, n)
        part = seg_full_max_bounded_plain(f[:, w0:w1], l[:, w0:w1],
                                          xt[:, w0:w1], bound)
        tiled[:, t0:t0 + tile] = part[:, t0 - w0:t0 - w0 + tile]
    assert torch.equal(tiled, whole)
    # a window one row short of the halo misses that segment's head
    if halo:
        short = torch.full_like(whole, float("nan"))
        for t0 in range(0, n, tile):
            w0, w1 = max(t0 - halo + 1, 0), min(t0 + tile + halo - 1, n)
            part = seg_full_max_bounded_plain(f[:, w0:w1], l[:, w0:w1],
                                              xt[:, w0:w1], bound)
            short[:, t0:t0 + tile] = part[:, t0 - w0:t0 - w0 + tile]
        assert not torch.equal(short, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 18, 32, 64, 384])
def test_seg_max_bwd_plan_tiles_with_a_halo_in_shared_memory(dtype, c):
    """K5b's plan: chunks of up to ``SEG_BWD_CHUNK`` 16-byte vectors of a
    row, tiles of at most ``SEG_BWD_TILE`` rows and ``SEG_BWD_WORK`` rows
    times vectors (64 rows at least), halved once where the grid would not
    fill the card; the last tile short where N is no multiple of it; a halo
    of bound - 1 rows on each side; its shared memory within a block's 227
    KB at every width the wrapper pads to; 32-bit offsets at the main
    paths' sizes."""
    from minddet_tpu_torch.ops import seg_max as sm

    padded = sm.pad_channels(torch.empty(1, 1, c, dtype=dtype,
                                         device="meta")).shape[-1]
    nv = padded // (4 if dtype == torch.float32 else 8)
    for b, n, bound in ((8, 120000, 20), (1, 120000, 20), (1, 1281, 1),
                        (2, 255, 64)):
        plan = sm.seg_max_bwd_plan(b, n, padded, dtype, bound, 2 * padded)
        tile, chunk = plan["tile_rows"], plan["chunk"]
        assert chunk == min(nv, sm.SEG_BWD_CHUNK) and plan["halo"] == bound - 1
        assert 64 <= tile <= sm.SEG_BWD_TILE
        assert tile * chunk <= sm.SEG_BWD_WORK or tile == 64
        assert plan["blocks"] == b * -(-n // tile) * -(-nv // chunk)
        window = tile + 2 * (bound - 1)
        assert plan["smem"] >= 12 * tile + window * (32 * chunk + 2)
        assert plan["smem"] <= 227 * 1024
        assert not plan["wide"]
    # the main paths' shapes: a whole row of C = 32 a block, 512 row
    # vectors; the batch-1 bf16 stream in tiles of 64 rows, to fill the card
    bf = sm.seg_max_bwd_plan(8, 120000, 32, torch.bfloat16, 20, 64)
    f32 = sm.seg_max_bwd_plan(4, 120000, 32, torch.float32, 20, 64)
    one = sm.seg_max_bwd_plan(1, 120000, 32, torch.bfloat16, 20)
    assert (bf["tile_rows"], bf["chunk"], bf["blocks"]) == (128, 4, 7504)
    assert (f32["tile_rows"], f32["chunk"], f32["blocks"]) == (64, 8, 7500)
    assert (one["tile_rows"], one["blocks"]) == (64, 1875)


def test_seg_max_bwd_plan_goes_wide_past_2_31_vectors_and_refuses():
    """64-bit row offsets from 2**31 vectors of g's rows on (its row stride
    counts: the cat's slice is 2C wide); refusals past the kernel's int
    arguments, past a block's shared memory and past the grid."""
    from minddet_tpu_torch.ops import seg_max as sm

    bf = torch.bfloat16
    n = 2 ** 28  # 8 bf16 channels: one vector a row
    assert not sm.seg_max_bwd_plan(1, n - 1, 8, bf, 20)["wide"]
    assert sm.seg_max_bwd_plan(8, n, 8, bf, 20)["wide"]
    assert not sm.seg_max_bwd_plan(4, n - 1, 8, bf, 20)["wide"]
    assert sm.seg_max_bwd_plan(4, n, 8, bf, 20, g_stride=16)["wide"]
    for args in ((1, 2 ** 31, 8, bf, 20), (1, 100, 2 ** 31, bf, 20),
                 (1, 100, 8, bf, 2 ** 31), (1, 100, 8, bf, 20, 2 ** 31)):
        with pytest.raises(ValueError, match="32-bit"):
            sm.seg_max_bwd_plan(*args)
    assert sm.seg_max_bwd_plan(1, 100, 32, bf, 3000)["chunk"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        sm.seg_max_bwd_plan(1, 100, 8, bf, 4000)
    with pytest.raises(ValueError, match="bound"):
        sm.seg_max_bwd_plan(1, 100, 8, bf, 0)
    with pytest.raises(ValueError, match="grid"):
        sm.seg_max_bwd_plan(2 ** 16, 2 ** 31 - 1, 8, bf, 20)


@pytest.mark.parametrize("case", ["cat slice", "contiguous",
                                  "misaligned", "channel-strided",
                                  "rows too close", "samples apart",
                                  "type"])
def test_backward_check_takes_the_cats_slice_and_refuses_the_rest(case):
    """What K5b takes of g (meta tensors: nothing is allocated): the second
    half of the PFN's (B, N, 2C) gradient and a contiguous g; not a g one
    element off 16-byte alignment, with a channel stride, with rows closer
    than C apart, with samples other than N rows apart, or of another
    type."""
    from minddet_tpu_torch.ops import seg_max as sm

    x = torch.empty(4, 1000, 32, dtype=torch.bfloat16, device="meta")
    full = torch.empty(4, 1000, 64, dtype=torch.bfloat16, device="meta")
    g = {"cat slice": full[..., 32:],
         "contiguous": torch.empty_like(x),
         "misaligned": torch.empty(4, 1000, 72, dtype=torch.bfloat16,
                                   device="meta")[..., 1:33],
         "channel-strided": full[..., ::2],
         "rows too close": full.as_strided((4, 1000, 32),
                                           (16000, 16, 1)),
         "samples apart": full.view(4, 2000, 32)[:, :1000],
         "type": torch.empty(4, 1000, 32, device="meta")}[case]
    if case in ("cat slice", "contiguous"):
        sm._check_bwd(x, g)
        return
    if case == "samples apart":  # 2000 rows apart, not N = 1000
        assert g.stride()[1:] == (32, 1)
    with pytest.raises(ValueError):
        sm._check_bwd(x, g)


def test_gradient_through_the_pfn_cat_reads_the_slice_in_place(monkeypatch):
    """The stream PFN's non-last layer route, ``torch.cat([x, seg max])``:
    the gradient reaches the segment max's backward as the strided second
    half of the cat's (no copy), and x's gradient equals the one computed
    from the same g made contiguous and the reference's VJP of the same
    concatenation (Pallas backward in interpret mode; f32 sums in another
    order, ties split evenly on both sides, atol 1e-5)."""
    from minddet_tpu_torch.ops import seg_max as sm

    rs = np.random.RandomState(11)
    bound, c = 6, 8
    first, last, x = _random_stream(rs, 2, 512, bound, c=c)
    w = rs.randn(2, 512, 2 * c).astype(np.float32)
    seen = []
    bwd = sm.seg_full_max_bounded_bwd

    def spy(first, last, x, m, g, bound):
        seen.append((g.is_contiguous(), g.stride()))
        return bwd(first, last, x, m, g, bound)

    monkeypatch.setattr(sm, "seg_full_max_bounded_bwd", spy)
    f, l = torch.from_numpy(first), torch.from_numpy(last)
    xt = torch.from_numpy(x).requires_grad_()
    y = torch.cat([xt, seg_full_max_bounded(f, l, xt, bound)], dim=-1)
    (y * torch.from_numpy(w)).sum().backward()
    assert seen == [(False, (512 * 2 * c, 2 * c, 1))]
    m = seg_full_max_bounded_plain(f, l, xt.detach(), bound)
    want = torch.from_numpy(w[..., :c]) + seg_full_max_bounded_bwd_plain(
        f, l, xt.detach(), m, torch.from_numpy(w[..., c:]).contiguous(),
        bound)
    assert torch.equal(xt.grad, want)
    jf, jl = jnp.asarray(first), jnp.asarray(last)
    _, vjp = jax.vjp(lambda v: jnp.concatenate(
        [v, j_seg_full_max(jf, jl, v, bound, block_rows=128,
                           interpret=True)], axis=-1), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(w))[0])
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-5, atol=1e-5)
